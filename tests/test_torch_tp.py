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
  * ``tp.plan`` follows the placements: the regions a mesh splits (for
    vlm, moe, ssm and hybrid too: arctic at full size on (16, 16) keeps
    its 56 heads whole and splits the experts, the MLP and the vocab;
    the smoke mamba2's 8 heads keep its mixer whole over 16 though its
    d_inner divides), none for the encdec family, a model axis of 1 or a
    batch over ``model``;
  * one MoE block over a group of 2 and 4 (moonshot, and arctic with its
    dense residual, each of the experts' and the MLP's regions split or
    whole): the members' outputs equal the whole block's, and the
    gradients of every expert block, of the router and of the input are
    the whole block's, the router's and the input's bit-equal over the
    members (the aux loss enters no region, so its gradient is not taken
    T times);
  * one Mamba2 layer (``lm._ssm_block_tp``) over a group of 2 and 4, and
    one zamba2 shared-block application followed by a Mamba2 layer: the
    members' outputs equal the whole layer's, each split leaf's gradient
    is its block of the whole gradient and ``wB``, ``wC`` and the input's
    are whole (the gated norm's sum of squares and ``wB`` / ``wC`` must
    sum their gradients over the group, or these are partial);
  * the loss of a vlm (with patches), a MoE, an ssm and a hybrid model
    over a group of 2 equals the one-position loss, with each member's
    gradients its blocks of the whole ones.
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


ATTENTION_CASES = [(4, 2, 2), (4, 2, 4), (8, 2, 2), (4, 1, 4), (8, 8, 2),
                   (12, 3, 2)]


@pytest.mark.parametrize("heads,kv,t,cross", [
    pytest.param(h, kv, t, False, id=f"{h}-{kv}-{t}")
    for h, kv, t in ATTENTION_CASES] + [
    pytest.param(h, kv, t, True, id=f"{h}-{kv}-{t}-cross")
    for h, kv, t in ((4, 2, 2), (4, 2, 4), (12, 3, 2))])
def test_attention_members_sum_to_the_whole(heads, kv, t, cross):
    """Self-attention, or a cross-attention (``kv_x``: 3 memory rows, no
    rope and no bias on its keys and values, every key valid)."""
    cfg = _cfg(heads, kv, True)
    g = torch.Generator().manual_seed(heads * 10 + kv + t)
    p = {k: 0.2 * torch.randn(s.shape, generator=g)
         for k, s in L.attention_specs(cfg, cross=cross).items()}
    x = torch.randn(2, 5, cfg.d_model, generator=g)
    kv_x = torch.randn(2, 3, cfg.d_model, generator=g) if cross else None
    pos = torch.arange(5)[None, :]
    want, _ = L.multihead_attention(cfg, p, x, positions=pos, kv_x=kv_x)
    h = heads // t
    parts = []
    for r in range(t):
        mine = dict(p, wq=p["wq"][:, r * h:(r + 1) * h],
                    bq=p["bq"][r * h:(r + 1) * h],
                    wo=p["wo"][r * h:(r + 1) * h])
        parts.append(L.multihead_attention(cfg, mine, x, positions=pos,
                                           kv_x=kv_x, heads=(r, t))[0])
    torch.testing.assert_close(sum(parts), want, rtol=TOL, atol=TOL)
    if cross:
        return
    # with a cache (placed prefill): each member writes every kv head of
    # the new tokens into its block of the sequence (rows [4r, 4r + 4) of
    # 8, or the whole), attends its heads over the whole sequence (the
    # blocks gathered before the call, ``kv_seq``), and the members sum
    # to the whole attention; the blocks are the whole cache's
    hd = cfg.resolved_head_dim

    def cache(rows=8):
        return {"k": torch.zeros(2, rows, kv, hd),
                "v": torch.zeros(2, rows, kv, hd)}

    whole = cache()
    want, _ = L.multihead_attention(cfg, p, x, positions=pos,
                                    kv_cache=whole)
    for blocks in (1, 2):
        parts = []
        for r in range(t):
            mine = dict(p, wq=p["wq"][:, r * h:(r + 1) * h],
                        bq=p["bq"][r * h:(r + 1) * h],
                        wo=p["wo"][r * h:(r + 1) * h])
            k0, k1 = L.head_slice(cfg, r, t)[2:]
            parts.append([])
            for b in range(blocks):
                c = cache(8 // blocks)
                seq = None if blocks == 1 else (
                    torch.zeros(2, 8, k1 - k0, hd),
                    torch.zeros(2, 8, k1 - k0, hd))
                out = L.multihead_attention(
                    cfg, mine, x, positions=pos, heads=(r, t), kv_cache=c,
                    kv_start=b * 8 // blocks, kv_seq=seq)[0]
                parts[-1].append(out)
                for n in ("k", "v"):
                    assert torch.equal(c[n], whole[n][:, b * 8 // blocks:
                                                      (b + 1) * 8 // blocks])
        # every block of a member computes the same output
        assert all(torch.equal(o, ps[0]) for ps in parts for o in ps)
        torch.testing.assert_close(sum(ps[0] for ps in parts), want,
                                   rtol=TOL, atol=TOL)


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
    # the encoder-decoder: the heads of every self- and cross-attention
    # and both stacks' d_ff; vocab 257 does not split by 2, 256 does
    plan = _plan("seamless-m4t-medium", 2, 2)
    assert (plan.heads, plan.mlp, plan.vocab, plan.experts, plan.ssm) == \
        (True, True, False, False, False)
    api = p_registry.get("seamless-m4t-medium", smoke=True)
    paths = [path for path, _ in TP.tree_flatten_with_path(api.abstract())]
    split = sorted("/".join(path) for path, d in zip(paths, plan.dims)
                   if d is not None)
    assert split == sorted(
        [f"{stack}/{sub}/{leaf}"
         for stack, subs in (("enc_blocks", ("attn",)),
                             ("dec_blocks", ("attn", "xattn")))
         for sub in subs for leaf in ("wo", "wq")]
        + [f"{stack}/mlp/{leaf}" for stack in ("dec_blocks", "enc_blocks")
           for leaf in ("b_up", "w_down", "w_up")])
    assert _plan("seamless-m4t-medium", 2, 2, vocab=256).vocab
    assert not _plan("seamless-m4t-medium", 1, 4, vocab=258).vocab
    plan = _plan("mamba2-1.3b", 2, 2)
    assert (plan.heads, plan.mlp, plan.vocab, plan.ssm) == \
        (False, False, False, True)
    api = p_registry.get("mamba2-1.3b", smoke=True)
    paths = [path for path, _ in TP.tree_flatten_with_path(api.abstract())]
    split = sorted(path[-1] for path, d in zip(paths, plan.dims)
                   if d is not None)
    assert split == sorted(path[-1] for path, _ in TP.REGIONS["ssm"])
    # 8 heads do not split 16 ways, d_inner 128 would: the mixer stays
    # whole, its heads' channels with them
    assert _plan("mamba2-1.3b", 1, 16) is None
    plan = _plan("zamba2-2.7b", 2, 2, vocab=256)
    assert (plan.heads, plan.mlp, plan.vocab, plan.experts, plan.ssm) == \
        (True, True, True, False, True)
    plan = _plan("phi-3-vision-4.2b", 2, 2)
    assert (plan.heads, plan.mlp, plan.vocab, plan.experts) == \
        (True, True, False, False)
    plan = _plan("moonshot-v1-16b-a3b", 2, 2, vocab=256)
    assert (plan.heads, plan.mlp, plan.vocab, plan.experts) == \
        (True, False, True, True)


@pytest.mark.parametrize("arch,regions", [
    ("arctic-480b", (False, True, True, True, False)),
    ("moonshot-v1-16b-a3b", (True, False, True, True, False)),
    ("phi-3-vision-4.2b", (True, True, True, False, False)),
    ("mamba2-1.3b", (False, False, False, False, True)),
    ("zamba2-2.7b", (True, True, True, False, True)),
    ("seamless-m4t-medium", (True, True, False, False, False))])
def test_plan_at_full_size_on_the_production_mesh(arch, regions):
    """At full size on (16, 16): arctic's 56 heads do not split 16 ways
    (the placement keeps them whole, as the reference's ``_demote_spec``),
    its experts' d_ff, dense-residual MLP and vocab do; moonshot has no
    dense MLP; phi-3-vision has no experts; mamba2's 64 heads split (4 a
    member), its vocab 50280 does not; zamba2's 80 Mamba2 heads (5 a
    member), its shared block's 32 heads and d_ff and its vocab 32000
    split; seamless-m4t-medium's 16 heads of every self- and
    cross-attention (1 a member) and both stacks' d_ff split, its vocab
    256206 does not (256206 % 16 = 14).  The router, the mixers' ``wB`` /
    ``wC`` and every attention's ``wk`` / ``wv`` are whole on every
    member."""
    api = p_registry.get(arch)
    mesh = p_mesh.make_production_mesh(device="meta")
    plan = p_train.make_sharded_train_step(
        api, make_optimizer("sgdm"), None, mesh).tp
    assert (plan.heads, plan.mlp, plan.vocab, plan.experts, plan.ssm) == \
        regions
    paths = ["/".join(path) for path, _ in
             TP.tree_flatten_with_path(api.abstract())]
    split = {p for p, d in zip(paths, plan.dims) if d is not None}
    want = {"/".join(path) for region, on in zip(
        ("heads", "mlp", "vocab", "experts", "ssm"), regions) if on
        for path, _ in TP.REGIONS[region] if "/".join(path) in paths}
    assert split == want
    assert not split & {"blocks/moe/router", "blocks/ssm/wB",
                        "blocks/ssm/wC", "blocks/attn/wk", "blocks/attn/wv",
                        "enc_blocks/attn/wk", "dec_blocks/xattn/wv"}


def _split_block(p, r, t, regions=("heads", "mlp")):
    """Member ``r`` of ``t``'s view of one layer's params: its block of
    each leaf of ``regions`` (``TP.REGIONS``, the layer dim dropped), the
    others whole."""
    p = {k: dict(v) if isinstance(v, dict) else v for k, v in p.items()}
    for region in regions:
        for path, dim in TP.REGIONS[region]:
            if path[0] != "blocks" or path[2] not in p.get(path[1], {}):
                continue
            x = p[path[1]][path[2]]
            n = x.shape[dim - 1] // t
            p[path[1]][path[2]] = x.narrow(dim - 1, r * n, n)
    return p


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
    outs, auxs = lm._attn_block_tp(cfg, group,
                                   [treedef.unflatten(m) for m in members],
                                   xs, positions=[pos, pos])
    assert auxs == [None, None]
    torch.autograd.backward([(o * cot).sum() for o in outs])
    for o in outs:
        torch.testing.assert_close(o, want, rtol=TOL, atol=TOL)
    _members_grads_are_blocks(specs, members, whole, xs, xw)


def _members_grads_are_blocks(specs, members, whole, xs, xw,
                              largest=False):
    """Each member's gradient of a split leaf is its block of the whole
    gradient (the blocks concatenated over the group); of a whole leaf and
    of the input, the whole gradient, bit-equal over the members.  With
    ``largest``, "equal" is within TOL of the leaf's largest element
    where that is above 1, as for a whole model's loss (a Mamba2 layer's
    gradients reach tens, summed over the group in other orders)."""
    def close(got, want, what):
        if largest:
            top = max(1.0, float(want.abs().max()))
            err = float((got - want).abs().max())
            assert err <= TOL * top, f"{what}: {err} of {top}"
            return
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL,
                                   msg=lambda m: f"{what}: {m}")

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
            for g in grads[1:]:
                assert torch.equal(g, grads[0]), path
        close(got, whole[i].grad, path)
    for xi in xs:
        close(xi.grad, xw.grad, "x")
        assert torch.equal(xi.grad, xs[0].grad)


MOE_CASES = [("moonshot-v1-16b-a3b", t, True, False) for t in (2, 4)] + \
    [("arctic-480b", t, experts, mlp) for t in (2, 4)
     for experts, mlp in ((True, True), (True, False), (False, True))]


@pytest.mark.parametrize("arch,t,experts,mlp", MOE_CASES)
def test_moe_block_members_equal_the_whole_block(arch, t, experts, mlp):
    """One MoE layer (``lm._attn_block_tp``: attention, then the experts
    and, for arctic, the dense residual MLP) over a group of ``t``
    against ``lm._attn_block`` on one position, the heads split, the
    experts' and the MLP's regions each split or whole.  Every member's
    output and aux loss equal the whole block's (``b_down`` once, a whole
    region's term not summed ``t`` times); the gradients, the loss seeded
    with the aux loss too, of every expert block are the whole gradient's
    blocks, and the router's and the input's equal the whole ones on
    every member, bit-equal over the members (a router that entered the
    region would take the aux loss's gradient ``t`` times)."""
    from repro_torch.core.treepath import tree_flatten

    cfg = p_registry.get(arch, smoke=True).cfg
    g = torch.Generator().manual_seed(t * 4 + 2 * experts + mlp)
    specs = lm._attn_block_specs(cfg)
    leaves, treedef = tree_flatten(specs)
    p = treedef.unflatten([0.1 * torch.randn(s.shape, generator=g)
                           for s in leaves])
    x = torch.randn(2, 6, cfg.d_model, generator=g)
    cot = torch.randn(2, 6, cfg.d_model, generator=g)
    pos = torch.arange(6)[None, :]

    whole = [v.clone().requires_grad_() for v in tree_flatten(p)[0]]
    xw = x.clone().requires_grad_()
    want, want_aux = lm._attn_block(cfg, treedef.unflatten(whole), xw,
                                    positions=pos, cache=None,
                                    kv_valid_len=None)
    ((want * cot).sum() + want_aux).backward()

    group = _group(t, mlp=mlp, experts=experts)
    regions = ["heads"] + ["experts"] * experts + ["mlp"] * mlp
    members = [[v.clone().requires_grad_() for v in tree_flatten(
        _split_block(p, r, t, regions))[0]] for r in range(t)]
    xs = [x.clone().requires_grad_() for _ in range(t)]
    outs, auxs = lm._attn_block_tp(cfg, group,
                                   [treedef.unflatten(m) for m in members],
                                   xs, positions=[pos] * t)
    torch.autograd.backward([(o * cot).sum() + a
                             for o, a in zip(outs, auxs)])
    for o, a in zip(outs, auxs):
        torch.testing.assert_close(o, want, rtol=TOL, atol=TOL)
        assert torch.equal(a, auxs[0])
        torch.testing.assert_close(a, want_aux, rtol=TOL, atol=TOL)
    _members_grads_are_blocks(specs, members, whole, xs, xw)
    router = [path for path, _ in TP.tree_flatten_with_path(specs)] \
        .index(("moe", "router"))
    assert whole[router].grad.abs().max() > 0


@pytest.mark.parametrize("t", [2, 4])
def test_ssm_block_members_equal_the_whole_block(t):
    """One mamba2 smoke layer (``lm._ssm_block_tp``, 8 heads: 4 and 2 a
    member) against ``lm._ssm_block`` on one position, 12 steps over
    chunks of 8 (a padded last chunk): each member's output equals the
    layer's, its gradients of the mixer's split leaves are its blocks of
    the whole ones, and the gradients of ``ln1``, of ``wB`` / ``wC`` (whole:
    every head reads the one ``Bm`` / ``Cm``) and of the input are the
    whole ones on every member, bit-equal over the members.  The gated
    norm's sum of squares must sum its gradient over the group too
    (``tp.total``), or every split leaf's gradient misses the other
    members' terms; ``wB`` / ``wC`` must enter the region, or theirs and
    the input's are partial."""
    from repro_torch.core.treepath import tree_flatten

    cfg = p_registry.get("mamba2-1.3b", smoke=True).cfg
    g = torch.Generator().manual_seed(7 + t)
    specs = lm._ssm_block_specs(cfg)
    leaves, treedef = tree_flatten(specs)
    p = treedef.unflatten([0.2 * torch.randn(s.shape, generator=g)
                           for s in leaves])
    x = torch.randn(2, 12, cfg.d_model, generator=g)
    cot = torch.randn(2, 12, cfg.d_model, generator=g)

    whole = [v.clone().requires_grad_() for v in tree_flatten(p)[0]]
    xw = x.clone().requires_grad_()
    want, _ = lm._ssm_block(cfg, treedef.unflatten(whole), xw, cache=None)
    (want * cot).sum().backward()

    group = _group(t, heads=False, mlp=False, vocab=False, ssm=True)
    members = [[v.clone().requires_grad_() for v in tree_flatten(
        _split_block(p, r, t, ("ssm",)))[0]] for r in range(t)]
    xs = [x.clone().requires_grad_() for _ in range(t)]
    outs = lm._ssm_block_tp(cfg, group,
                            [treedef.unflatten(m) for m in members], xs)
    torch.autograd.backward([(o * cot).sum() for o in outs])
    for o in outs:
        torch.testing.assert_close(o, want, rtol=TOL, atol=TOL)
    _members_grads_are_blocks(specs, members, whole, xs, xw, largest=True)


@pytest.mark.parametrize("t", [2, 4])
def test_hybrid_shared_block_members_equal_the_whole(t):
    """One application of zamba2's shared block, then a Mamba2 layer, as
    the hybrid stack runs them (the smoke's 4 heads on 2 kv heads, d_ff
    96 and 8 SSM heads over 2 and 4 members), against ``lm._attn_block``
    and ``lm._ssm_block`` on one position: outputs equal, each split
    leaf's gradient is its block of the whole one, ``wk`` / ``wv`` /
    ``wB`` / ``wC``, the norms' and the input's whole."""
    from repro_torch.core.treepath import tree_flatten

    cfg = p_registry.get("zamba2-2.7b", smoke=True).cfg
    g = torch.Generator().manual_seed(11 + t)
    specs = {"layer": lm._ssm_block_specs(cfg),
             "shared_attn": lm._attn_block_specs(cfg)}
    leaves, treedef = tree_flatten(specs)
    p = treedef.unflatten([0.2 * torch.randn(s.shape, generator=g)
                           for s in leaves])
    x = torch.randn(2, 12, cfg.d_model, generator=g)
    cot = torch.randn(2, 12, cfg.d_model, generator=g)
    pos = torch.arange(12)[None, :]

    whole = [v.clone().requires_grad_() for v in tree_flatten(p)[0]]
    xw = x.clone().requires_grad_()
    w = treedef.unflatten(whole)
    want, _ = lm._attn_block(cfg, w["shared_attn"], xw, positions=pos,
                             cache=None, kv_valid_len=None)
    want, _ = lm._ssm_block(cfg, w["layer"], want, cache=None)
    (want * cot).sum().backward()

    group = _group(t, vocab=False, ssm=True)
    members = [[v.clone().requires_grad_() for v in tree_flatten({
        "layer": _split_block(p["layer"], r, t, ("ssm",)),
        "shared_attn": _split_block(p["shared_attn"], r, t)})[0]]
        for r in range(t)]
    ms = [treedef.unflatten(m) for m in members]
    xs = [x.clone().requires_grad_() for _ in range(t)]
    outs, _ = lm._attn_block_tp(cfg, group, [m["shared_attn"] for m in ms],
                                xs, positions=[pos] * t)
    outs = lm._ssm_block_tp(cfg, group, [m["layer"] for m in ms], outs)
    torch.autograd.backward([(o * cot).sum() for o in outs])
    for o in outs:
        torch.testing.assert_close(o, want, rtol=TOL, atol=TOL)
    _members_grads_are_blocks(specs, members, whole, xs, xw, largest=True)


def _stack_members(p, stack, t, stacked):
    """Each of ``t`` members' view of ``p``, one layer (``stacked``
    False: the layer dim dropped) or the whole stack of ``stack``
    (``"enc_blocks"`` / ``"dec_blocks"``): its block of each leaf of the
    heads and mlp regions, the others whole; each leaf a fresh leaf that
    requires grad, flat in ``p``'s order."""
    from repro_torch.core.treepath import tree_flatten_with_path

    dims = {path[1:]: d - (not stacked)
            for region in ("heads", "mlp") for path, d in TP.REGIONS[region]
            if path[0] == stack}
    members = []
    for r in range(t):
        mine = []
        for path, v in tree_flatten_with_path(p):
            d = dims.get(path)
            if d is not None:
                n = v.shape[d] // t
                v = v.narrow(d, r * n, n)
            mine.append(v.clone().requires_grad_())
        members.append(mine)
    return members


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("part", ["encoder", "decoder"])
def test_encdec_block_members_equal_the_whole_block(part, t):
    """seamless-m4t-medium smoke (4 heads on 2 kv heads, d_ff 96, every
    bias and norm random) over a group of ``t``: one encoder block
    (``encdec._enc_block_tp``, non-causal) against ``encdec._enc_block``,
    or the decoder stack's 2 blocks (``encdec._decode_stack_tp``: the
    causal self-attention, the cross-attention over 3 rows of memory, the
    MLP) against ``encdec._decode_stack`` on one position.  Each
    member's output equals the whole one, its gradients of the split
    leaves (``wq`` / ``wo`` of every attention, ``w_up`` / ``b_up`` /
    ``w_down``) are its blocks of the whole gradients, and the gradients
    of the whole leaves (the norms, every ``wk`` / ``wv``, ``b_down``),
    of the input and of the memory equal the whole ones, bit-equal over
    the members.  The memory must enter the heads' region (its gradient
    is partial on each member otherwise), and so must the
    cross-attention's ``wk`` / ``wv``."""
    from repro_torch.core.treepath import tree_flatten
    from repro_torch.models import encdec

    cfg = p_registry.get("seamless-m4t-medium", smoke=True).cfg
    g = torch.Generator().manual_seed(13 + t + 10 * (part == "decoder"))
    stack = "enc_blocks" if part == "encoder" else "dec_blocks"
    specs = encdec.spec_tree(cfg)[stack]
    leaves, treedef = tree_flatten(specs)
    p = treedef.unflatten([0.3 * torch.randn(v.shape, generator=g)
                           for v in leaves])
    if part == "encoder":
        p = treedef.unflatten([v[0] for v in tree_flatten(p)[0]])
    x = torch.randn(2, 6, cfg.d_model, generator=g)
    mem = torch.randn(2, 3, cfg.d_model, generator=g)
    cot = torch.randn(2, 6, cfg.d_model, generator=g)
    pos = torch.arange(6)[None, :]

    whole = [v.clone().requires_grad_() for v in tree_flatten(p)[0]]
    xw, mw = x.clone().requires_grad_(), mem.clone().requires_grad_()
    group = _group(t, vocab=False)
    members = _stack_members(p, stack, t, part == "decoder")
    ps = [treedef.unflatten(m) if part == "decoder" else
          tree_flatten(p)[1].unflatten(m) for m in members]
    xs = [x.clone().requires_grad_() for _ in range(t)]
    mems = [mem.clone().requires_grad_() for _ in range(t)]
    if part == "encoder":
        want = encdec._enc_block(cfg, tree_flatten(p)[1].unflatten(whole),
                                 xw, positions=pos)
        outs = encdec._enc_block_tp(cfg, group, ps, xs, positions=[pos] * t)
    else:
        want = encdec._decode_stack(cfg, {"dec_blocks": treedef.unflatten(
            whole)}, xw, mw, positions=pos, cache=None, kv_valid_len=None)
        outs = encdec._decode_stack_tp(cfg, group, ps, xs, mems,
                                       positions=[pos] * t)
    (want * cot).sum().backward()
    torch.autograd.backward([(o * cot).sum() for o in outs])
    for o in outs:
        torch.testing.assert_close(o, want, rtol=TOL, atol=TOL)
    # two decoder layers' gradients reach tens: held within TOL of each
    # leaf's largest element, as a whole model's are
    deep = part == "decoder"
    _members_grads_are_blocks(p, members, whole, xs, xw, largest=deep)
    if deep:
        top = float(mw.grad.abs().max())
        for m in mems:
            err = float((m.grad - mw.grad).abs().max())
            assert err <= TOL * max(1.0, top), f"memory: {err} of {top}"
            assert torch.equal(m.grad, mems[0].grad)


def _member_params(params, plan, r, t):
    """Member ``r`` of ``t``'s params: its block of each leaf ``plan``
    splits."""
    from repro_torch.core.treepath import tree_flatten

    leaves, treedef = tree_flatten(params)
    out = []
    for v, d in zip(leaves, plan.dims):
        if d is not None:
            n = v.shape[d] // t
            v = v.narrow(d, r * n, n)
        out.append(v.clone().requires_grad_())
    return treedef.unflatten(out)


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "arctic-480b"])
def test_vlm_and_moe_loss_over_a_group_equal_one_positions(arch):
    """``loss_fn(group=)`` at vocab 256 over a group of 2 (every region
    the placements split on a (1, 2) mesh), phi-3-vision with its patches:
    each member's loss (+ 0.01 aux) and aux equal the one-position
    ``loss_fn``'s, and its gradients are its blocks of the whole ones (a
    whole leaf's bit-equal over the members)."""
    plan = _loss_over_a_group(arch)
    assert plan.vocab and plan.mlp and not plan.ssm
    assert plan.experts == (arch == "arctic-480b")


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_ssm_and_hybrid_loss_over_a_group_equal_one_positions(arch):
    """As the vlm and MoE losses: mamba2 (its mixers and the vocab split)
    and zamba2 (also its shared block's heads and d_ff, applied before
    each of its 2 layers' first: once at the smoke's 2 layers) at vocab
    256 over a group of 2."""
    plan = _loss_over_a_group(arch)
    assert plan.vocab and plan.ssm and not plan.experts
    assert plan.heads == plan.mlp == (arch == "zamba2-2.7b")


def _loss_over_a_group(arch):
    """``arch``'s smoke model at vocab 256: ``loss_fn(group=)`` over a
    group of 2 against ``loss_fn`` on one position, the labels partly
    masked; returns the plan."""
    from repro_torch.core.treepath import tree_flatten, tree_leaves

    api = p_registry.get_model(dataclasses.replace(
        p_registry.get(arch, smoke=True).cfg, vocab_size=256))
    cfg = api.cfg
    plan = _plan(arch, 1, 2, vocab=256)
    params = api.init(torch.Generator().manual_seed(5), device="cpu")
    g = torch.Generator().manual_seed(6)
    batch = {"tokens": torch.randint(0, 256, (2, 8), generator=g),
             "labels": torch.randint(0, 256, (2, 8), generator=g)}
    batch["labels"][0, :3] = -1
    if cfg.frontend == "vision":
        batch["patches"] = torch.randn(2, cfg.frontend_tokens, cfg.d_model,
                                       generator=g)
    whole = tree_flatten(params)[0]
    whole = [v.clone().requires_grad_() for v in whole]
    total, metrics = api.loss_fn(tree_flatten(params)[1].unflatten(whole),
                                 batch)
    total.backward()
    group = TP.ModelGroup(p_mesh.make_debug_mesh(1, 2, device="cpu"),
                          (0, 1), heads=plan.heads, mlp=plan.mlp,
                          vocab=plan.vocab, experts=plan.experts,
                          ssm=plan.ssm)
    members = [_member_params(params, plan, r, 2) for r in range(2)]
    totals, ms = api.loss_fn(members, [batch, batch], group=group)
    torch.autograd.backward(totals)
    for tot, m in zip(totals, ms):
        torch.testing.assert_close(tot, total, rtol=TOL, atol=TOL)
        torch.testing.assert_close(m["aux_loss"], metrics["aux_loss"],
                                   rtol=TOL, atol=TOL)
    for i, (w, d) in enumerate(zip(whole, plan.dims)):
        grads = [tree_leaves(m)[i].grad for m in members]
        got = torch.cat(grads, dim=d) if d is not None else grads[0]
        if d is None:
            assert torch.equal(grads[1], grads[0]), i
        # float32 sums in other orders: within TOL of the leaf's largest
        # element where that is above 1 (the embedding's, about 20)
        top = float(w.grad.abs().max())
        assert float((got - w.grad).abs().max()) <= TOL * max(1.0, top), i
    return plan


def test_other_families_are_refused():
    """``lm._loss_tp`` refuses a family outside ``tp.FAMILIES`` (every
    family of the registry is in it)."""
    api = p_registry.get("llama3.2-1b", smoke=True)
    cfg = dataclasses.replace(api.cfg, family="retnet")
    assert cfg.family not in TP.FAMILIES
    with pytest.raises(ValueError, match="tensor parallelism"):
        lm.loss_fn(cfg, [None], [{}], group=_group(2))
    assert {p_registry.get(a, smoke=True).cfg.family
            for a in p_registry.ARCH_IDS} <= set(TP.FAMILIES)
