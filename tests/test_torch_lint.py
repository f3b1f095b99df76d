"""The port's DC2xx AST lint (plus the repo-clean gates).

The 16 cases of ``tests/test_lint.py`` as torch snippets, every torch
DC201 primitive flagged outside the allowlist (and a plain dtype cast
not), the gate ``lint_repo() == []`` over ``src/repro_torch``, and the
reference's own gate, which this port leaves untouched.
"""
import textwrap

import pytest

from repro_torch.analysis.lint import (DEFAULT_ROOTS, RAW_CALL_ALLOWLIST,
                                       lint_repo, lint_source, main)


def _codes(diags):
    return [d.code for d in diags]


def _lint(src, rel="src/repro_torch/runtime/example.py"):
    return lint_source(textwrap.dedent(src), rel)


# -- DC201: raw transfer/sync calls ------------------------------------------

def test_dc201_raw_synchronize_outside_allowlist():
    diags = _lint("""
        import torch
        def f(x):
            return torch.cuda.synchronize()
    """)
    assert _codes(diags) == ["DC201"]
    assert diags[0].where == "src/repro_torch/runtime/example.py:4"


def test_dc201_raw_non_blocking_copy():
    assert _codes(_lint("""
        y.copy_(x, non_blocking=True)
    """)) == ["DC201"]


def test_dc201_allowlisted_file_clean():
    rel = next(iter(RAW_CALL_ALLOWLIST))
    assert _lint("""
        import torch
        y = x.to("cuda", non_blocking=True)
        torch.cuda.synchronize(y.device)
    """, rel=rel) == []


def test_dc201_waiver_same_line_and_line_above():
    assert _lint("""
        import torch
        torch.cuda.synchronize()  # lint: allow=DC201 -- measuring raw sync
        # lint: allow=DC201 -- warmup
        event.synchronize()
    """) == []


def test_waiver_for_other_code_does_not_suppress():
    assert _codes(_lint("""
        import torch
        torch.cuda.synchronize()  # lint: allow=DC204 -- wrong code
    """)) == ["DC201"]


@pytest.mark.parametrize("call", [
    "torch.cuda.synchronize()",
    "torch.cuda.synchronize(dev)",
    "torch.cuda.current_stream(dev).synchronize()",
    "event.synchronize()",
    "stream.synchronize()",
    "y.copy_(x, non_blocking=True)",
    "x.to(dev, non_blocking=True)",
    "x.cuda()",
    "x.cuda(0)",
    "x.pin_memory()",
    "torch.empty(4, pin_memory=True)",
    "torch.zeros(4, pin_memory=flag)",
    'x.to("cuda")',
    'x.to("cuda:1", torch.bfloat16)',
    "x.to(device=dev)",
    "x.to(device=dev, dtype=torch.long)",
])
def test_dc201_every_torch_primitive_is_flagged(call):
    assert _codes(_lint(call)) == ["DC201"], call


@pytest.mark.parametrize("call", [
    "x.to(torch.float32)",
    "x.to(dtype=torch.bfloat16)",
    "x.to(other)",
    'torch.device("cuda", 0)',
    "torch.cuda.is_available()",
    "torch.zeros(4, pin_memory=False)",
    "y.copy_(x, non_blocking=False)",
    "x.float().cpu()",
])
def test_dc201_plain_calls_are_clean(call):
    assert _lint(call) == [], call


# -- DC202: fault-point literals ---------------------------------------------

def test_dc202_unknown_trip_literal():
    diags = _lint("""
        from repro_torch.runtime import faults
        faults.trip("serve.decode_stepp")
    """)
    assert _codes(diags) == ["DC202"]
    assert "serve.decode_stepp" in diags[0].message


def test_dc202_known_point_and_constants_clean():
    assert _lint("""
        from repro_torch.runtime import faults as faults_lib
        faults_lib.trip("serve.decode_step")
        faults_lib.trip(faults_lib.SERVE_DECODE_STEP)
        _trip("ckpt.pack")
    """) == []


def test_dc202_point_keyword():
    assert _codes(_lint("""
        run_elastic(step, point="restore.h2dd")
    """)) == ["DC202"]


# -- DC203: spec/policy literals ---------------------------------------------

def test_dc203_bad_spec_literal():
    diags = _lint("""
        from repro_torch.core.spec import TransferSpec
        TransferSpec.parse("marshal+dbb")
    """)
    assert _codes(diags) == ["DC203"]


def test_dc203_bad_policy_literal_and_declared_policy_kwarg():
    diags = _lint("""
        from repro_torch.core.policy import TransferPolicy
        TransferPolicy.parse("params/**=nosuchkind; **=marshal")
        Scenario(declared_policy="params/**=marshal")  # missing ** default
    """)
    assert _codes(diags) == ["DC203", "DC203"]


def test_dc203_good_literals_and_fstrings_clean():
    assert _lint("""
        from repro_torch.core.policy import TransferPolicy
        from repro_torch.core.spec import TransferSpec
        TransferSpec.parse("marshal+delta@dp8")
        TransferPolicy.parse("params/**=marshal+db; **=pointerchain")
        TransferPolicy.of("uvm")
        TransferPolicy.parse(f"**=marshal@dp{k}")
    """) == []


# -- DC204: arena writes without mark_dirty ----------------------------------

def test_dc204_staging_write_without_mark_dirty():
    diags = _lint("""
        def poke(entry):
            entry.staging["float32"][0] = 1.0
    """)
    assert _codes(diags) == ["DC204"]


def test_dc204_augassign_and_shard_views():
    assert _codes(_lint("""
        def poke(entry, views):
            entry.shard_views()["float32"][0][:] += 1.0
    """)) == ["DC204"]


def test_dc204_clean_with_mark_dirty_in_scope():
    assert _lint("""
        def poke(entry):
            entry.staging["float32"][0] = 1.0
            entry.mark_dirty("float32")
        def poke2(entry):
            entry.staging["float32"][0] = 1.0
            entry.bump_version()
    """) == []


def test_dc204_ordinary_subscript_writes_clean():
    assert _lint("""
        def f(d):
            d["k"] = 1
            d["k"][0] += 2
    """) == []


# -- repo gates ---------------------------------------------------------------

def test_repo_is_lint_clean():
    assert DEFAULT_ROOTS == ("src/repro_torch",)
    diags = lint_repo()
    assert diags == [], [str(d) for d in diags]


def test_main_strict_exits_zero_on_the_repo(capsys):
    assert main(["--strict"]) == 0
    assert capsys.readouterr().out.strip().endswith("0 finding(s)")


def test_every_waiver_gives_its_reason():
    """Each DC201 waiver in the port names why (``-- <why>``); the lint's
    own docstrings show the grammar and are not waivers."""
    from repro_torch.analysis.lint import REPO_ROOT

    waivers = [(f, line) for f in sorted((REPO_ROOT / "src/repro_torch")
                                         .rglob("*.py"))
               if f.name != "lint.py"
               for line in f.read_text().splitlines()
               if "# lint: allow=" in line]
    assert waivers
    for f, line in waivers:
        reason = line.split("# lint: allow=", 1)[1].partition("--")[2]
        assert len(reason.strip()) > 10, (f, line)


def test_reference_lint_is_still_clean():
    from repro.analysis.lint import lint_repo as reference_lint_repo

    diags = reference_lint_repo()
    assert diags == [], [str(d) for d in diags]


def test_syntax_error_reported_as_dc203():
    diags = lint_source("def broken(:\n", "src/repro_torch/x.py")
    assert _codes(diags) == ["DC203"]
