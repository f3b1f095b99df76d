"""Tensor parallelism over the model axis (``repro_torch.models.tp``) on
CPU positions, held to the model's one-position functions.

  * ``multihead_attention(heads=(r, T))``: the members' partial outputs
    summed equal the whole attention, for head layouts where a member's
    query heads read a slice of the kv heads, one kv head, or (12 heads
    on 3 kv heads over 2 members) kv heads that its heads do not map onto
    as ``j // (h / kv)``;
  * the vocab-parallel embedding and cross-entropy equal
    ``lm.embed_tokens`` / ``lm.cross_entropy``, and their gradients
    (through ``enter`` / ``leave``) are each member's block of the whole
    gradient, bit-equal over the members where the value is replicated;
  * ``tp.plan`` follows the placements: the regions a mesh splits, none
    for another family, a model axis of 1 or a batch over ``model``.
"""
import dataclasses

import pytest
import torch

from repro_torch.launch import mesh as p_mesh
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models import registry as p_registry
from repro_torch.models import tp as TP
from repro_torch.optim import make_optimizer
from repro_torch.runtime import train as p_train

# float32 sums in other orders (the plain attention and the cross-entropy
# compute in float32)
TOL = 1e-5


def _group(t, **regions):
    mesh = p_mesh.make_debug_mesh(1, t, device="cpu")
    kw = {"heads": True, "mlp": True, "vocab": True, **regions}
    return TP.ModelGroup(mesh, mesh.groups("model")[0], **kw)


def _cfg(heads, kv, bias):
    base = p_registry.get("qwen1.5-110b", smoke=True).cfg
    return dataclasses.replace(base, num_heads=heads, num_kv_heads=kv,
                               head_dim=8, d_model=32, qkv_bias=bias)


@pytest.mark.parametrize("heads,kv,t", [(4, 2, 2), (4, 2, 4), (8, 2, 2),
                                        (4, 1, 4), (8, 8, 2), (12, 3, 2)])
def test_attention_members_sum_to_the_whole(heads, kv, t):
    cfg = _cfg(heads, kv, True)
    g = torch.Generator().manual_seed(heads * 10 + kv + t)
    p = {k: 0.2 * torch.randn(s.shape, generator=g)
         for k, s in L.attention_specs(cfg).items()}
    x = torch.randn(2, 5, cfg.d_model, generator=g)
    pos = torch.arange(5)[None, :]
    want, _ = L.multihead_attention(cfg, p, x, positions=pos)
    h = heads // t
    parts = []
    for r in range(t):
        mine = dict(p, wq=p["wq"][:, r * h:(r + 1) * h],
                    bq=p["bq"][r * h:(r + 1) * h],
                    wo=p["wo"][r * h:(r + 1) * h])
        parts.append(L.multihead_attention(cfg, mine, x, positions=pos,
                                           heads=(r, t))[0])
    torch.testing.assert_close(sum(parts), want, rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="cache"):
        L.multihead_attention(cfg, p, x, positions=pos, heads=(0, t),
                              kv_x=x)


@pytest.mark.parametrize("t", [2, 4])
def test_vocab_parallel_embedding_and_cross_entropy(t):
    V, D = 16, 6
    g = torch.Generator().manual_seed(t)
    tok = torch.randn(V, D, generator=g)
    x = torch.randn(2, 3, D, generator=g)
    tokens = torch.randint(0, V, (2, 3), generator=g)
    labels = torch.randint(0, V, (2, 3), generator=g)
    labels[0, 1] = -1
    group = _group(t)

    # one position: the embedding, then the tied head on x, then the CE
    w = tok.clone().requires_grad_()
    xw = x.clone().requires_grad_()
    e = w[tokens]
    want, count = lm.cross_entropy((xw + e) @ w.T, labels)
    want.backward()

    blocks = [tok[r * V // t:(r + 1) * V // t].clone().requires_grad_()
              for r in range(t)]
    xs = [x.clone().requires_grad_() for _ in range(t)]
    es = TP.embed(group, blocks, [tokens] * t, torch.float32)
    hs = TP.enter(group, [a + b for a, b in zip(xs, es)])
    out = TP.cross_entropy(group, [h @ b.T for h, b in zip(hs, blocks)],
                           [labels] * t)
    # every member seeds the backward with its own copy of the loss
    torch.autograd.backward([loss for loss, _ in out])
    for loss, n in out:
        torch.testing.assert_close(loss, want, rtol=TOL, atol=TOL)
        assert torch.equal(n, count) and torch.equal(loss, out[0][0])
    torch.testing.assert_close(torch.cat([b.grad for b in blocks]), w.grad,
                               rtol=TOL, atol=TOL)
    for xi in xs:
        torch.testing.assert_close(xi.grad, xw.grad, rtol=TOL, atol=TOL)
        assert torch.equal(xi.grad, xs[0].grad)


def test_stand_in_member_computes_alone():
    """The dry run's group: member 0 alone, the collective's other slots
    standing in with its tensor."""
    group = _group(4)
    plan = TP.Plan(True, True, True, ())
    alone = plan.stand_in(group.mesh)
    assert alone.ranks == (0,) and alone.size == 4
    x = torch.ones(3)
    assert torch.equal(alone.psum([x])[0], 4 * x)
    with pytest.raises(ValueError, match="computed members"):
        alone.psum([x, x])


def _plan(arch, data, model, vocab=None, batch_over_model=False):
    api = p_registry.get(arch, smoke=True)
    if vocab:
        api = p_registry.get_model(dataclasses.replace(api.cfg,
                                                       vocab_size=vocab))
    mesh = p_mesh.make_debug_mesh(data, model, device="meta")
    rules = p_mesh.rules_for(api.cfg, mesh, "train")
    if batch_over_model:
        rules["batch"] = ("data", "model")
    return p_train.make_sharded_train_step(api, make_optimizer("sgdm"),
                                           None, mesh, rules).tp


def test_plan_follows_the_placements():
    plan = _plan("llama3.2-1b", 2, 2)
    assert (plan.heads, plan.mlp, plan.vocab) == (True, True, False)
    plan = _plan("llama3.2-1b", 2, 2, vocab=256)
    assert (plan.heads, plan.mlp, plan.vocab) == (True, True, True)
    # 4 heads do not split 8 ways; d_ff 96 does
    plan = _plan("starcoder2-3b", 1, 8)
    assert (plan.heads, plan.mlp, plan.vocab) == (False, True, False)
    api = p_registry.get("starcoder2-3b", smoke=True)
    paths = [path for path, _ in TP.tree_flatten_with_path(api.abstract())]
    split = sorted("/".join(path) for path, d in zip(paths, plan.dims)
                   if d is not None)
    assert split == ["blocks/mlp/b_up", "blocks/mlp/w_down",
                     "blocks/mlp/w_up"]
    assert _plan("llama3.2-1b", 4, 1) is None
    assert _plan("llama3.2-1b", 2, 2, batch_over_model=True) is None
    for arch in ("moonshot-v1-16b-a3b", "mamba2-1.3b", "phi-3-vision-4.2b"):
        assert _plan(arch, 2, 2) is None


def _split_block(p, r, t):
    """Member ``r`` of ``t``'s view of one layer's params: its block of
    the query heads' and d_ff's leaves, the others whole."""
    def cut(x, dim):
        n = x.shape[dim] // t
        return x.narrow(dim, r * n, n)

    attn = dict(p["attn"], wq=cut(p["attn"]["wq"], 1),
                wo=cut(p["attn"]["wo"], 0))
    if "bq" in attn:
        attn["bq"] = cut(p["attn"]["bq"], 0)
    mlp = {k: cut(v, 0 if k in ("w_down", "b_up") else 1)
           if k != "b_down" else v for k, v in p["mlp"].items()}
    return dict(p, attn=attn, mlp=mlp)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "starcoder2-3b"])
def test_block_members_equal_the_whole_block(arch):
    """One layer (``lm._attn_block_tp``) over a group of 2 against
    ``lm._attn_block`` on one position, every bias nonzero: each member's
    output equals the block's (``b_down`` added once), the members'
    gradients of their blocks are the whole gradient's blocks, and the
    replicated leaves' gradients (the norms, ``wk`` / ``wv`` read in kv
    slices, ``b_down``) and the input's equal the whole ones on every
    member, bit-equal over the members."""
    from repro_torch.core.treepath import tree_flatten

    cfg = p_registry.get(arch, smoke=True).cfg
    g = torch.Generator().manual_seed(3)
    specs = lm._attn_block_specs(cfg)
    leaves, treedef = tree_flatten(specs)
    p = treedef.unflatten([0.3 * torch.randn(s.shape, generator=g)
                           for s in leaves])
    x = torch.randn(2, 6, cfg.d_model, generator=g)
    cot = torch.randn(2, 6, cfg.d_model, generator=g)
    pos = torch.arange(6)[None, :]

    whole = [t.clone().requires_grad_() for t in tree_flatten(p)[0]]
    xw = x.clone().requires_grad_()
    want, _ = lm._attn_block(cfg, treedef.unflatten(whole), xw,
                             positions=pos, cache=None, kv_valid_len=None)
    (want * cot).sum().backward()

    group = _group(2)
    members = [[t.clone().requires_grad_() for t in
                tree_flatten(_split_block(p, r, 2))[0]] for r in range(2)]
    xs = [x.clone().requires_grad_() for _ in range(2)]
    outs = lm._attn_block_tp(cfg, group,
                             [treedef.unflatten(m) for m in members], xs,
                             positions=[pos, pos])
    torch.autograd.backward([(o * cot).sum() for o in outs])
    for o in outs:
        torch.testing.assert_close(o, want, rtol=TOL, atol=TOL)
    paths = [path for path, _ in TP.tree_flatten_with_path(specs)]
    for i, path in enumerate(paths):
        grads = [m[i].grad for m in members]
        split = grads[0].shape != whole[i].grad.shape
        if split:
            dim = [a != b for a, b in zip(grads[0].shape,
                                          whole[i].grad.shape)].index(True)
            got = torch.cat(grads, dim=dim)
        else:
            got = grads[0]
            assert torch.equal(grads[1], grads[0]), path
        torch.testing.assert_close(got, whole[i].grad, rtol=TOL, atol=TOL,
                                   msg=lambda m: f"{path}: {m}")
    for xi in xs:
        torch.testing.assert_close(xi.grad, xw.grad, rtol=TOL, atol=TOL)
    assert torch.equal(xs[0].grad, xs[1].grad)
