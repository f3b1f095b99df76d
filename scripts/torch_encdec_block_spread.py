#!/usr/bin/env python3
"""How far float32 computations of seamless-m4t-medium's blocks at full
width lie from the float64 value of the same block: the grounds of the
tolerance of ``tests/test_torch_cuda.py``'s
``test_encdec_tensor_parallel_blocks_at_full_width``.

One encoder block and one decoder block (the causal self-attention, the
cross-attention over 32 rows of memory, the MLP), float32 params drawn on
the card from seed 0, batch 2 x 128, memory 2 x 32, a random cotangent
(seed 1), as the card test draws them.  For each, per leaf, the largest
|a - b| of the gradient over its largest element in b, where b is the
float64 gradient computed on the host (the port's model with the float32
casts of its norms and of the attention's plain version patched out):
``whole_card`` (``encdec._enc_block`` / ``_decode_stack`` on the card:
the kernels' forward, the plain version's gradient), ``whole_host_f32``
(the same in float32 on the host), ``tp<T>_card`` (the
tensor-parallel block, ``_enc_block_tp`` / ``_decode_stack_tp``, over a
model group of T positions of the card, each member's split gradients
concatenated); and ``tp<T>_vs_whole_card``.  One JSON line a block and
reading, its four largest leaves.

Usage (from the repository root, on the card; builds the flash kernel):

    python3 scripts/torch_encdec_block_spread.py
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


@contextlib.contextmanager
def float64_model():
    """The norms and the attention's plain version in their inputs'
    dtype (for this reading only)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.models import layers as L

    attention = flash_ref.attention_ref

    def attention_ref(q, k, v, **kw):
        with mock.patch.object(torch.Tensor, "float", lambda t: t):
            return attention(q, k, v, **kw)

    def apply_norm(cfg, p, x):
        return F.layer_norm(x, x.shape[-1:], p["scale"].to(x.dtype),
                            p["bias"].to(x.dtype), eps=1e-5)

    with mock.patch.object(flash_ref, "attention_ref", attention_ref), \
            mock.patch.object(L, "apply_norm", apply_norm):
        yield


def gradients(cfg, part, t, dev, dtype, p, x, mem, cot):
    """The gradients of sum(out * cot) in ``p``'s flat order: the whole
    block (``t`` None) or the tensor-parallel one over ``t`` positions of
    ``dev``, each split leaf's member blocks concatenated."""
    import torch
    from repro_torch.core.treepath import tree_flatten, tree_flatten_with_path
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import encdec
    from repro_torch.models import tp as TP

    stack = "enc_blocks" if part == "encoder" else "dec_blocks"
    leaves, treedef = tree_flatten(p)
    paths = [path for path, _ in tree_flatten_with_path(p)]
    leaves = [v.to(dev, dtype) for v in leaves]
    x, mem, cot = (v.to(dev, dtype) for v in (x, mem, cot))
    pos = torch.arange(x.shape[1], device=dev)[None, :]
    if t is None:
        dims, n = {}, 1
    else:
        drop = part == "encoder"
        dims = {path[1:]: d - drop for region in ("heads", "mlp")
                for path, d in TP.REGIONS[region] if path[0] == stack}
        n = t
    members = []
    for r in range(n):
        mine = []
        for path, v in zip(paths, leaves):
            d = dims.get(path)
            if d is not None:
                k = v.shape[d] // n
                v = v.narrow(d, r * k, k)
            mine.append(v.clone().requires_grad_())
        members.append(mine)
    ps = [treedef.unflatten(m) for m in members]
    xs = [x.clone() for _ in range(n)]
    mems = [mem.clone() for _ in range(n)]
    if t is None:
        if part == "encoder":
            outs = [encdec._enc_block(cfg, ps[0], xs[0], positions=pos)]
        else:
            outs = [encdec._decode_stack(cfg, {"dec_blocks": ps[0]}, xs[0],
                                         mems[0], positions=pos, cache=None,
                                         kv_valid_len=None)]
    else:
        mesh = make_debug_mesh(1, t, device=(dev,) * t)
        group = TP.ModelGroup(mesh, mesh.groups("model")[0], heads=True,
                              mlp=True, vocab=False)
        if part == "encoder":
            outs = encdec._enc_block_tp(cfg, group, ps, xs,
                                        positions=[pos] * t)
        else:
            outs = encdec._decode_stack_tp(cfg, group, ps, xs, mems,
                                           positions=[pos] * t)
    torch.autograd.backward([(o * cot).sum() for o in outs])
    out = []
    for i, path in enumerate(paths):
        d = dims.get(path)
        g = [m[i].grad for m in members]
        out.append(torch.cat(g, dim=d) if d is not None else g[0])
    return paths, out


def main():
    import torch
    from repro_torch.core.treepath import tree_flatten
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.models import encdec, registry
    from repro_torch.models.specs import init_params

    import chip_smoke

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.build_kernels([FK.SOURCE])
    cuda, host = torch.device("cuda", 0), torch.device("cpu")
    cfg = dataclasses.replace(registry.get("seamless-m4t-medium").cfg,
                              num_layers=1)
    for part in ("encoder", "decoder"):
        stack = "enc_blocks" if part == "encoder" else "dec_blocks"
        p = init_params(encdec.spec_tree(cfg)[stack],
                        torch.Generator(device=cuda).manual_seed(0),
                        "float32", cuda)
        if part == "encoder":
            leaves, treedef = tree_flatten(p)
            p = treedef.unflatten([v[0] for v in leaves])
        g = torch.Generator(device=cuda).manual_seed(1)
        x = torch.randn(2, 128, cfg.d_model, device=cuda, generator=g)
        mem = torch.randn(2, 32, cfg.d_model, device=cuda, generator=g)
        cot = torch.randn(2, 128, cfg.d_model, device=cuda, generator=g)
        args = (p, x, mem, cot)
        with float64_model():
            paths, g64 = gradients(cfg, part, None, host, torch.float64,
                                   *args)
        reads = {"whole_card": gradients(cfg, part, None, cuda,
                                         torch.float32, *args)[1],
                 "whole_host_f32": gradients(cfg, part, None, host,
                                             torch.float32, *args)[1]}
        for t in (2, 4):
            reads[f"tp{t}_card"] = gradients(cfg, part, t, cuda,
                                             torch.float32, *args)[1]

        def worst(got, want):
            gaps = sorted(((float((a.double().cpu() - b.double().cpu())
                                  .abs().max() / b.abs().max()),
                            "/".join(path))
                           for a, b, path in zip(got, want, paths)),
                          reverse=True)
            return [[f"{e:.3e}", n] for e, n in gaps[:4]]

        for name, grads in reads.items():
            print(json.dumps({"block": part, "reading": name,
                              "vs_f64": worst(grads, g64)}), flush=True)
        for t in (2, 4):
            print(json.dumps({"block": part, "reading":
                              f"tp{t}_vs_whole_card",
                              "gap": worst(reads[f"tp{t}_card"],
                                           reads["whole_card"])}),
                  flush=True)


if __name__ == "__main__":
    main()
