"""The four ``examples/torch_*.py`` on the CPU, each through its
``main(argv)`` with ``--device cpu`` at its smallest size, held to the JAX
package's example of the same name.

One child process runs the reference's examples and prints what they
print: ``quickstart.py``; ``deepcopy_demo.py --k 3 --n 1000 --q 3``;
``serve_lm.py``; and, for ``train_lm.py``, the model line only (its
config's parameter count: the reference's 300-step run is not repeated
here).  Held:

  * quickstart: every line equal (tree bytes, the declared chain, each
    scheme's transfers and KB, the policy program's regions, the arena);
  * deepcopy demo: each spec's H2D DMAs, MB and check, in order (the walls
    are the host's);
  * serve: requests served, tokens, the policy and the lifecycle counts,
    and each shown request's prompt length (the tokens differ: the port
    draws its weights from ``torch.Generator``, not ``jax.random``);
  * train: the model line, and one step with a failure before it ends
    with one restart and a finite loss.
"""
import functools
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
DEMO_ARGS = ["--k", "3", "--n", "1000", "--q", "3"]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads while this module runs: the suite runs in
    several processes on one host, and more threads than cores spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(2, n))
    yield
    torch.set_num_threads(n)

_CHILD = r'''
import contextlib, importlib.util, io, json, sys
sys.path.insert(0, "examples")

def load(name):
    spec = importlib.util.spec_from_file_location(name, "examples/%s.py" % name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

out = {}
for name, argv in (("quickstart", []), ("deepcopy_demo", DEMO_ARGS),
                   ("serve_lm", [])):
    buf = io.StringIO()
    sys.argv = [name] + argv
    with contextlib.redirect_stdout(buf):
        load(name).main()
    out[name] = buf.getvalue()
train = load("train_lm")
from repro.models import lm
from repro.models.specs import param_count
cfg = train.config_100m()
out["train_lm"] = "model: %s  params=%.1fM" % (
    cfg.name, param_count(lm.spec_tree(cfg)) / 1e6)
json.dump(out, open(OUT, "w"))
'''


@functools.lru_cache(maxsize=None)
def reference_examples(path: str) -> dict:
    """What the reference's examples print, run once per process."""
    import json
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    code = _CHILD.replace("DEMO_ARGS", repr(DEMO_ARGS)) \
        .replace("OUT", repr(path))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference_examples(
        str(tmp_path_factory.mktemp("examples_reference") / "ref.json"))


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_prints_the_references_motion(ref, capsys):
    _example("quickstart").main(["--device", "cpu"])
    assert capsys.readouterr().out == ref["quickstart"]


_DEMO = re.compile(r"^\s+(\S.*?)\s+wall .*H2D\s+(\d+) DMAs /\s+([\d.]+) MB"
                   r"\s+check=(\w+)", re.M)


def test_deepcopy_demo_moves_what_the_reference_moves(ref, capsys):
    _example("deepcopy_demo").main(DEMO_ARGS + ["--device", "cpu"])
    got = _DEMO.findall(capsys.readouterr().out)
    want = _DEMO.findall(ref["deepcopy_demo"])
    assert len(want) == 10 and got == want
    assert all(check == "ok" for *_, check in got)


def _serve_summary(text):
    served = re.search(r"served (\d+) requests, (\d+) tokens", text).groups()
    policy = re.search(r"policy (.*)$", text, re.M).group(1)
    prompts = re.findall(r"req (\d+): prompt\[(\d+)\]", text)
    return served, policy, prompts


def test_serve_lm_serves_what_the_reference_serves(ref, capsys):
    done = _example("serve_lm").main(["--device", "cpu"])
    assert _serve_summary(capsys.readouterr().out) == \
        _serve_summary(ref["serve_lm"])
    assert len(done) == 8


def test_train_lm_restarts_from_its_checkpoint(ref, capsys, tmp_path):
    res = _example("train_lm").main(
        ["--device", "cpu", "--steps", "1", "--batch", "1", "--seq", "8",
         "--fail-at", "0", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.splitlines()[0] == ref["train_lm"]
    assert res.restarts == 1
    assert "restarts: 1" in out
    assert all(m["loss"] == m["loss"] for m in res.metrics_history)
