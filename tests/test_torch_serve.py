"""The port's Server against the JAX package's, on the smoke llama (f32)
on the CPU.

The same requests go through both servers, the port's with the
reference's weights (``params_from_reference``).  Every scenario of
tests/test_serve.py is held to the reference's outcome: the same
``tokens_out`` per rid, the same terminal states and error types, equal
``stats.as_dict()``, and the install program's region ledgers
(313088 B / 1 copy for the params, 65544 / 2 for the cache, 16 / 2 for the
slot table).  The smoke mamba2 and zamba2 (f32) are served the same way,
under the same requests and the ``serve.decode_step`` / prefill fault
retries: a retried decode step starts from the cache it was given, so the
SSM state and conv tail of a step are never half applied.
"""
import jax
import jax.numpy as jnp
import ml_dtypes  # noqa: F401  (registers numpy's bfloat16 for the reference)
import numpy as np
import pytest
import torch

from repro.models import registry as r_registry
from repro.runtime import InjectedFault as RInjectedFault
from repro.runtime import Request as RRequest
from repro.runtime import Server as RServer
from repro.runtime import injected as r_injected
from repro.runtime import serve_transfer_policy as r_serve_policy

from repro_torch import NoCudaDeviceError
from repro_torch.convert import params_from_reference
from repro_torch.models import registry as p_registry
from repro_torch.runtime import (ACCEPTED, SHED, InjectedFault,
                                 LifecycleError, Request, RequestTimeout,
                                 Server, injected, serve_transfer_policy)

CPU = "cpu"
LEDGERS = {"params/**": (313088, 1), "cache/**": (65544, 2), "**": (16, 2)}


@pytest.fixture(scope="module")
def models():
    api = r_registry.get("llama3.2-1b", smoke=True)
    params = api.init(jax.random.PRNGKey(0))
    port = p_registry.get("llama3.2-1b", smoke=True)
    return api, params, port, params_from_reference(jax.device_get(params),
                                                    CPU)


def _reqs(cls, n, seed=0, max_new=5):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, 257, 4 + (i % 5)).astype(
        np.int32), max_new_tokens=max_new) for i in range(n)]


def _servers(models, **kw):
    api, params, port, pp = models
    return (RServer(api, params, **kw),
            Server(port, pp, device=CPU, **kw))


def _outcome(done):
    return {r.rid: (r.state, list(r.tokens_out), type(r.error).__name__,
                    getattr(r.error, "where", None)) for r in done}


def _same(ref, port, ref_done, port_done):
    assert _outcome(port_done) == {
        rid: (s, t, e.replace("RInjected", "Injected"), w)
        for rid, (s, t, e, w) in _outcome(ref_done).items()}
    assert [r.rid for r in port_done] == [r.rid for r in ref_done]
    assert port.stats.as_dict() == ref.stats.as_dict()
    port.tracker.assert_conserved()


def _ledgers(server):
    return {k: (l.h2d_bytes, l.h2d_calls)
            for k, l in server.program.ledgers.items()}


def test_same_requests_same_tokens_stats_and_ledgers(models):
    ref, port = _servers(models, slots=2, max_seq=64)
    assert _ledgers(port) == _ledgers(ref) == LEDGERS
    assert str(port.policy) == str(ref.policy) == str(r_serve_policy())
    for r in _reqs(RRequest, 5):
        ref.submit(r)
    for r in _reqs(Request, 5):
        port.submit(r)
    _same(ref, port, ref.run(max_steps=200), port.run(max_steps=200))
    assert port.stats.completed == 5 and port.stats.prefill_batches >= 2


def test_server_matches_manual_greedy_decode(models):
    api, _, port_api, pp = models
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, 257, 7).astype(np.int32)
    cache = port_api.init_cache(1, 64, device=CPU)
    logits, cache = port_api.prefill(pp, torch.from_numpy(prompt)[None], cache)
    want = [int(torch.argmax(logits[0, -1]))]
    for _ in range(4):
        logits, cache = port_api.decode_step(
            pp, torch.tensor([[want[-1]]], dtype=torch.int32), cache)
        want.append(int(torch.argmax(logits[0, -1])))
    server = Server(port_api, pp, slots=2, max_seq=64, device=CPU)
    server.submit(Request(rid=0, prompt=prompt, max_new_tokens=5))
    server.submit(Request(rid=1, prompt=rng.integers(0, 257, 3).astype(
        np.int32), max_new_tokens=5))
    got = next(r for r in server.run(max_steps=50) if r.rid == 0).tokens_out
    assert got == want


def test_eos_terminates_early(models):
    ref, port = _servers(models, slots=1, max_seq=32)
    want = _reqs(RRequest, 1, max_new=8)[0]
    ref.submit(want)
    ref.run(max_steps=50)
    eos = want.tokens_out[1]
    ref, port = _servers(models, slots=1, max_seq=32)
    for srv, cls in ((ref, RRequest), (port, Request)):
        req = _reqs(cls, 1, max_new=8)[0]
        req.eos_id = eos
        srv.submit(req)
    _same(ref, port, ref.run(max_steps=50), port.run(max_steps=50))
    assert len(port.tracker.finished()[0].tokens_out) <= 2


def test_shedding_equals_the_reference(models):
    ref, port = _servers(models, slots=1, max_seq=64, max_queue=8,
                         shed_watermark=2)
    verdicts = [[srv.submit(r) for r in _reqs(cls, 5)]
                for srv, cls in ((ref, RRequest), (port, Request))]
    assert verdicts[1] == verdicts[0] == [ACCEPTED, ACCEPTED, SHED, SHED,
                                          SHED]
    _same(ref, port, ref.run(max_steps=100), port.run(max_steps=100))
    assert port.stats.shed == 3 and port.stats.queue_high_water <= 2


def test_duplicate_rid_is_a_lifecycle_error(models):
    _, _, port_api, pp = models
    server = Server(port_api, pp, slots=1, max_seq=64, device=CPU)
    server.submit(Request(rid=7, prompt=np.asarray([1, 2], np.int32)))
    with pytest.raises(LifecycleError, match="duplicate rid"):
        server.submit(Request(rid=7, prompt=np.asarray([3], np.int32)))


@pytest.mark.parametrize("where", ["queued", "active"])
def test_deadline_expiry_equals_the_reference(models, where):
    outs = []
    for which in (0, 1):
        clock = {"t": 0.0}
        srv = _servers(models, slots=1, max_seq=64,
                       clock=lambda: clock["t"])[which]
        cls = (RRequest, Request)[which]
        if where == "queued":
            hog, victim = _reqs(cls, 2, max_new=10)
            victim.deadline_s = 1.0
            srv.submit(hog)
            srv.tick()
            srv.submit(victim)
        else:
            victim = _reqs(cls, 1, max_new=50)[0]
            victim.deadline_s = 1.0
            srv.submit(victim)
            srv.tick()
        clock["t"] = 5.0
        outs.append((srv, srv.run(max_steps=100), victim))
    (ref, ref_done, _), (port, port_done, victim) = outs
    assert victim.state == "timed_out"
    assert isinstance(victim.error, RequestTimeout)
    assert victim.error.where == where
    _same(ref, port, ref_done, port_done)


@pytest.mark.parametrize("point,at", [("serve.prefill_pack", 2),
                                      ("serve.decode_step", 2),
                                      ("serve.slot_refill", 2),
                                      ("serve.policy_swap", 1)])
def test_injected_faults_retry_like_the_reference(models, point, at):
    """Each serve fault point fires once and is retried: the same tokens,
    stats (one retry booked at the point) and terminal states as the
    reference under the same injection."""
    results = []
    for which, (inject, cls) in enumerate(((r_injected, RRequest),
                                           (injected, Request))):
        with inject(point, at=at) as inj:
            srv = _servers(models, slots=2, max_seq=64)[which]
            for r in _reqs(cls, 5):
                srv.submit(r)
            done = srv.run(max_steps=200)
        assert inj.fired == [(point, at)]
        results.append((srv, done))
    (ref, ref_done), (port, port_done) = results
    _same(ref, port, ref_done, port_done)
    assert port.stats.retries.get(point) == 1
    assert port.stats.completed == 5 and port.stats.failed == 0


def test_exhausted_retries_fail_typed_like_the_reference(models):
    results = []
    for which, (inject, cls) in enumerate(((r_injected, RRequest),
                                           (injected, Request))):
        srv = _servers(models, slots=1, max_seq=64, max_retries=0)[which]
        with inject("serve.decode_step", at=1):
            for r in _reqs(cls, 3):
                srv.submit(r)
            results.append((srv, srv.run(max_steps=200)))
    (ref, ref_done), (port, port_done) = results
    _same(ref, port, ref_done, port_done)
    states = {r.rid: r.state for r in port_done}
    assert states == {0: "failed", 1: "completed", 2: "completed"}
    assert isinstance(port_done[0].error, InjectedFault)
    assert isinstance(ref_done[0].error, RInjectedFault)


def test_swap_policy_mid_serving_equals_the_reference(models):
    ref, port = _servers(models, slots=2, max_seq=64)
    for srv, cls in ((ref, RRequest), (port, Request)):
        for r in _reqs(cls, 4, max_new=6):
            srv.submit(r)
        for _ in range(3):
            srv.tick()
        assert str(srv.swap_policy("marshal")) == "**=marshal"
    _same(ref, port, ref.run(max_steps=200), port.run(max_steps=200))
    assert _ledgers(port) == _ledgers(ref)


def test_stale_mesh_policy_degrades_loudly_like_the_reference(models):
    ref, port = _servers(models, slots=2, max_seq=64,
                         policy=str(serve_transfer_policy(2)))
    assert port.stats.policy_fallbacks == ref.stats.policy_fallbacks == 1
    assert port.stats.degradations and port.policy.num_shards == 1
    assert str(port.policy) == str(ref.policy)
    for srv, cls in ((ref, RRequest), (port, Request)):
        for r in _reqs(cls, 3):
            srv.submit(r)
    ref_done, port_done = ref.run(max_steps=200), port.run(max_steps=200)
    assert _outcome(port_done) == _outcome(ref_done)


def test_run_returns_requests_submitted_after_start(models):
    _, _, port_api, pp = models
    server = Server(port_api, pp, slots=1, max_seq=64, device=CPU)
    early, late = _reqs(Request, 2, max_new=3)
    server.submit(early)
    server.tick()
    server.submit(late)
    done = server.run(max_steps=100)
    assert {r.rid for r in done} == {0, 1}
    assert all(r.state == "completed" for r in done)


def test_server_defaults_to_the_card(models):
    _, _, port_api, pp = models
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is used")
    with pytest.raises(NoCudaDeviceError):
        Server(port_api, pp, slots=1, max_seq=16)


# -- the Mamba2 models (ssm, hybrid) -----------------------------------------

SSM_LEDGERS = {
    "mamba2-1.3b": {"params/**": (357632, 1), "cache/**": (38920, 2),
                    "**": (16, 2)},
    "zamba2-2.7b": {"params/**": (481792, 1), "cache/**": (71688, 2),
                    "**": (16, 2)},
}


@pytest.fixture(scope="module", params=sorted(SSM_LEDGERS))
def ssm_models(request):
    api = r_registry.get(request.param, smoke=True)
    params = api.init(jax.random.PRNGKey(0))
    port = p_registry.get(request.param, smoke=True)
    return api, params, port, params_from_reference(jax.device_get(params),
                                                    CPU)


def test_ssm_models_serve_like_the_reference(ssm_models):
    ref, port = _servers(ssm_models, slots=2, max_seq=64)
    assert _ledgers(port) == _ledgers(ref) \
        == SSM_LEDGERS[port.api.cfg.name.replace("-smoke", "")]
    for r in _reqs(RRequest, 5):
        ref.submit(r)
    for r in _reqs(Request, 5):
        port.submit(r)
    _same(ref, port, ref.run(max_steps=200), port.run(max_steps=200))
    assert port.stats.completed == 5 and port.stats.prefill_batches >= 2


@pytest.mark.parametrize("point,at", [("serve.decode_step", 2),
                                      ("serve.decode_step", 5),
                                      ("serve.prefill_pack", 2)])
def test_ssm_fault_retries_are_idempotent_like_the_reference(ssm_models,
                                                             point, at):
    """A retried decode step (or refill) recomputes from the same cache:
    the same tokens, stats and terminal states as the reference."""
    results = []
    for which, (inject, cls) in enumerate(((r_injected, RRequest),
                                           (injected, Request))):
        with inject(point, at=at) as inj:
            srv = _servers(ssm_models, slots=2, max_seq=64)[which]
            for r in _reqs(cls, 5):
                srv.submit(r)
            done = srv.run(max_steps=200)
        assert inj.fired == [(point, at)]
        results.append((srv, done))
    (ref, ref_done), (port, port_done) = results
    _same(ref, port, ref_done, port_done)
    assert port.stats.retries.get(point) == 1
    assert port.stats.completed == 5 and port.stats.failed == 0


def test_ssm_swap_policy_mid_serving_equals_the_reference(ssm_models):
    ref, port = _servers(ssm_models, slots=2, max_seq=64)
    for srv, cls in ((ref, RRequest), (port, Request)):
        for r in _reqs(cls, 4, max_new=6):
            srv.submit(r)
        for _ in range(3):
            srv.tick()
        assert str(srv.swap_policy("marshal")) == "**=marshal"
    _same(ref, port, ref.run(max_steps=200), port.run(max_steps=200))
    assert _ledgers(port) == _ledgers(ref)


def test_ssm_server_matches_manual_greedy_decode(ssm_models):
    _, _, port_api, pp = ssm_models
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, 257, 11).astype(np.int32)
    cache = port_api.init_cache(1, 64, device=CPU)
    logits, cache = port_api.prefill(pp, torch.from_numpy(prompt)[None], cache)
    want = [int(torch.argmax(logits[0, -1]))]
    for _ in range(4):
        logits, cache = port_api.decode_step(
            pp, torch.tensor([[want[-1]]], dtype=torch.int32), cache)
        want.append(int(torch.argmax(logits[0, -1])))
    server = Server(port_api, pp, slots=2, max_seq=64, device=CPU)
    server.submit(Request(rid=0, prompt=prompt, max_new_tokens=5))
    server.submit(Request(rid=1, prompt=rng.integers(0, 257, 3).astype(
        np.int32), max_new_tokens=5))
    got = next(r for r in server.run(max_steps=50) if r.rid == 0).tokens_out
    assert got == want
