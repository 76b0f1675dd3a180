"""apex_tpu_torch.serve against apex_tpu.serve on a tiny GPT.

The model is initialised by flax and carried across with
``GPT.params_from_jax``; inputs are made with numpy from a seed. Both sides
run fp32 on the CPU (the port through its kernels' plain versions, JAX
through its reference paths). Tolerances: cache writes are exact (a copy);
logits within 1e-4 absolute (fp32 through two blocks, other summation
order); greedy tokens equal. The port's own contracts — bit-exact
preempt/resume, the naive baseline equal to the engine, the scheduler's
state machine — are held as ``tests/test_serve.py`` holds the JAX engine.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import serve as jserve
from apex_tpu.models.gpt import GPT as JGPT
from apex_tpu.models.gpt import GPTConfig as JGPTConfig
from apex_tpu.serve import cache as jcache
from apex_tpu.serve import model as jmodel
from apex_tpu.transformer import parallel_state as ps
from apex_tpu_torch import serve
from apex_tpu_torch.models.gpt import GPT, GPTConfig
from apex_tpu_torch.serve import cache as tcache
from apex_tpu_torch.serve import model as tmodel
from apex_tpu_torch.serve.scheduler import (RUNNING, WAITING, PageAllocator,
                                            Scheduler, Sequence)

SHAPE = dict(vocab_size=64, max_seq_len=128, hidden_size=32, num_layers=2,
             num_heads=2)
JCFG = JGPTConfig(dtype=jnp.float32, **SHAPE)
CFG = GPTConfig(dtype=torch.float32, **SHAPE)
PROMPTS = [[5, 9, 17, 3, 40, 22, 8], [11, 2, 33, 60, 7, 7, 1]]
N_NEW = 12
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def jparams():
    ps.destroy_model_parallel()
    return JGPT(JCFG).init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def params(jparams):
    return GPT.params_from_jax(CFG, jax.device_get(jparams), device="cpu")


def _engine(params, *, num_pages=32, max_batch=2):
    return serve.ServeEngine(CFG, params, num_pages=num_pages,
                             max_seq_len=64, max_prompt_len=16, page_size=8,
                             max_batch=max_batch, record_logits=True,
                             device="cpu")


def _run(params, *, preempt_at=None, **kw):
    eng = _engine(params, **kw)
    ids = [eng.add_request(p, N_NEW) for p in PROMPTS]
    steps = 0
    while eng.sched.has_work:
        eng.step()
        steps += 1
        if preempt_at and steps == preempt_at and any(
                s.seq_id == ids[0] for s in eng.sched.running):
            eng.preempt(ids[0])
        assert steps < 500
    out = {i: eng.seqs[i].tokens[len(eng.seqs[i].prompt):] for i in ids}
    n_preempts = sum(eng.seqs[i].n_preemptions for i in ids)
    return eng, ids, out, n_preempts


def _random_state(ccfg_kw, seed):
    """The same random pools as a JAX CacheState and a port CacheState."""
    rng = np.random.RandomState(seed)
    shape = (ccfg_kw["num_layers"], ccfg_kw["kv_heads"],
             ccfg_kw["num_pages"], ccfg_kw["page_size"],
             ccfg_kw["head_dim"])
    k = (rng.randn(*shape) * 0.3).astype(np.float32)
    v = (rng.randn(*shape) * 0.3).astype(np.float32)
    return (jcache.CacheState(jnp.asarray(k), jnp.asarray(v), None, None),
            tcache.CacheState(torch.from_numpy(k.copy()),
                              torch.from_numpy(v.copy())))


def _ccfgs(**kw):
    return (jcache.CacheConfig(dtype=jnp.float32, **kw),
            tcache.CacheConfig(dtype=torch.float32, **kw))


def _assert_pools_equal(jstate, tstate, atol=0.0):
    np.testing.assert_allclose(tstate.k_pool.numpy(),
                               np.asarray(jstate.k_pool), atol=atol, rtol=0)
    np.testing.assert_allclose(tstate.v_pool.numpy(),
                               np.asarray(jstate.v_pool), atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def test_params_from_jax_keeps_names_and_layouts(jparams, params):
    flat = jax.tree_util.tree_flatten_with_path(jax.device_get(jparams))[0]
    names = dict(params.named_parameters())
    assert len(flat) == len(names)
    for path, leaf in flat:
        name = ".".join(str(p.key) for p in path)
        np.testing.assert_array_equal(names[name].detach().numpy(), np.asarray(leaf))
    assert tuple(params.block(0).attn.qkv.kernel.shape) == (32, 96)  # in,out
    assert tuple(params.wte.embedding.shape) == (64, 32)             # [V, h]
    bad = dict(jax.device_get(jparams))
    del bad["wpe"]
    with pytest.raises(ValueError, match="missing"):
        GPT.params_from_jax(CFG, bad, device="cpu")


def test_init_params_follows_flax_initialisers():
    cfg = GPTConfig(vocab_size=512, max_seq_len=64, hidden_size=128,
                    num_layers=1, num_heads=4, dtype=torch.float32)
    a = GPT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = GPT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for (n, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), n                 # seeded: reproducible
    k = a.block(0).mlp.fc1.kernel                      # lecun_normal
    assert abs(k.std().item() - 128 ** -0.5) < 0.05 * 128 ** -0.5
    assert k.abs().max().item() <= 2 * 128 ** -0.5 / .87962566103423978
    assert abs(a.wte.embedding.std().item() - 0.02) < 0.002
    assert torch.all(a.block(0).ln1.weight == 1)
    assert torch.all(a.block(0).attn.qkv.bias == 0)


# ---------------------------------------------------------------------------
# cache writes: the [kv, b, d] selection of the port against JAX's [b, kv, d]
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,kv", [(3, 2), (2, 2)])
def test_write_token_matches_jax(b, kv):
    kw = dict(num_layers=2, kv_heads=kv, head_dim=8, num_pages=6,
              page_size=4)
    jc, tc = _ccfgs(**kw)
    jstate, tstate = _random_state(kw, seed=b)
    rng = np.random.RandomState(10 + b)
    page_ids = np.asarray([3, 1, 5][:b], np.int32)
    slots = np.asarray([2, 0, 3][:b], np.int32)
    k_new = rng.randn(b, kv, 8).astype(np.float32)
    v_new = rng.randn(b, kv, 8).astype(np.float32)
    jstate = jcache.write_token(jc, jstate, 1, jnp.asarray(page_ids),
                                jnp.asarray(slots), jnp.asarray(k_new),
                                jnp.asarray(v_new))
    out = tcache.write_token(tc, tstate, 1, torch.from_numpy(page_ids),
                             torch.from_numpy(slots), torch.from_numpy(k_new),
                             torch.from_numpy(v_new))
    assert out is tstate                                   # in place
    _assert_pools_equal(jstate, tstate)


def test_write_prompt_matches_jax():
    kw = dict(num_layers=2, kv_heads=2, head_dim=8, num_pages=6, page_size=4)
    jc, tc = _ccfgs(**kw)
    jstate, tstate = _random_state(kw, seed=7)
    rng = np.random.RandomState(8)
    S, length = 10, 7                         # 3 padded positions -> page 0
    bt = np.asarray([4, 2, 5], np.int32)
    k_seq = rng.randn(S, 2, 8).astype(np.float32)
    v_seq = rng.randn(S, 2, 8).astype(np.float32)
    jstate = jcache.write_prompt(jc, jstate, 0, jnp.asarray(bt),
                                 jnp.int32(length), jnp.asarray(k_seq),
                                 jnp.asarray(v_seq))
    tcache.write_prompt(tc, tstate, 0, torch.from_numpy(bt), length,
                        torch.from_numpy(k_seq), torch.from_numpy(v_seq))
    _assert_pools_equal(jstate, tstate)


def test_resolve_page_size_explicit_then_heuristic():
    assert tcache.resolve_page_size(page_size=24, context_len=64) == 24
    for ctx in (1, 20, 64, 4096):
        assert tcache.resolve_page_size(context_len=ctx) == \
            jcache.resolve_page_size(context_len=ctx, kv_heads=2,
                                     head_dim=16, autotune="off")


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def test_decode_forward_matches_jax(jparams, params):
    kw = dict(num_layers=2, kv_heads=2, head_dim=16, num_pages=8,
              page_size=8)
    jc, tc = _ccfgs(**kw)
    jstate, tstate = _random_state(kw, seed=2)
    bt = np.asarray([[1, 2], [3, 4], [0, 0]], np.int32)
    pos = np.asarray([3, 9, 0], np.int32)
    tok = np.asarray([7, 9, 0], np.int32)
    act = np.asarray([True, True, False])
    jl, jstate = jmodel.decode_forward(
        JCFG, jc, jparams, jstate, jnp.asarray(bt), jnp.asarray(pos),
        jnp.asarray(tok), jnp.asarray(act))
    with torch.no_grad():
        tl, _ = tmodel.decode_forward(
            CFG, tc, params, tstate, torch.from_numpy(bt),
            torch.from_numpy(pos).long(), torch.from_numpy(tok).long(),
            torch.from_numpy(act))
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                               atol=LOGIT_TOL, rtol=0)
    _assert_pools_equal(jstate, tstate, atol=1e-5)


def test_prefill_forward_matches_jax(jparams, params):
    kw = dict(num_layers=2, kv_heads=2, head_dim=16, num_pages=8,
              page_size=8)
    jc, tc = _ccfgs(**kw)
    jstate, tstate = _random_state(kw, seed=3)
    prompt = PROMPTS[0]
    ids = np.asarray(prompt + [0] * (16 - len(prompt)), np.int32)
    bt = np.asarray([1, 2, 3], np.int32)
    jl, jstate = jmodel.prefill_forward(
        JCFG, jc, jparams, jstate, jnp.asarray(bt), jnp.int32(len(prompt)),
        jnp.asarray(ids))
    with torch.no_grad():
        tl, _ = tmodel.prefill_forward(
            CFG, tc, params, tstate, torch.from_numpy(bt), len(prompt),
            torch.from_numpy(ids).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    _assert_pools_equal(jstate, tstate, atol=1e-5)


@pytest.mark.parametrize("reference", [False, True])
def test_full_forward_logits_matches_jax(jparams, params, reference):
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 64, (3, 20)).astype(np.int32)
    lengths = np.asarray([20, 5, 13], np.int32)
    jl = jmodel.full_forward_logits(JCFG, jparams, jnp.asarray(ids),
                                    jnp.asarray(lengths))
    with torch.no_grad():
        tl = tmodel.full_forward_logits(CFG, params,
                                        torch.from_numpy(ids).long(),
                                        torch.from_numpy(lengths).long(),
                                        reference=reference)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def test_engine_greedy_tokens_match_jax_engine(jparams, params):
    jeng = jserve.ServeEngine(JCFG, jparams, num_pages=32, max_seq_len=64,
                              max_prompt_len=16, page_size=8, max_batch=2,
                              record_logits=True)
    jids = [jeng.add_request(p, N_NEW) for p in PROMPTS]
    jout = jeng.run()
    eng, ids, out, _ = _run(params)
    assert [out[i] for i in ids] == [jout[i] for i in jids]
    worst = max(float(np.max(np.abs(eng.logits_log[i][p]
                                    - jeng.logits_log[j][p])))
                for i, j in zip(ids, jids) for p in jeng.logits_log[j])
    assert worst < LOGIT_TOL, worst
    # every page back, no slot leaked
    assert eng.sched.allocator.free_pages == eng.ccfg.num_pages - 1
    assert eng.slots == [None, None]
    assert eng.tokens_generated == 2 * N_NEW


def _assert_logits_bitwise_equal(engA, engB, ids):
    for sid in ids:
        la, lb = engA.logits_log[sid], engB.logits_log[sid]
        assert set(la) == set(lb), (sid, sorted(la), sorted(lb))
        for pos in la:
            assert np.array_equal(la[pos], lb[pos]), (sid, pos)


def test_preempt_resume_bit_exact(params):
    engA, ids, outA, _ = _run(params)
    engB, _, outB, n_pre = _run(params, preempt_at=4)
    assert n_pre >= 1
    assert outA == outB
    _assert_logits_bitwise_equal(engA, engB, ids)


def test_organic_evict_readmit_bit_exact(params):
    engA, ids, outA, _ = _run(params, num_pages=32)
    engB, idsB, outB, n_pre = _run(params, num_pages=6)
    assert ids == idsB
    assert n_pre >= 1, "nothing evicted — shrink the pool so the test bites"
    assert outA == outB
    _assert_logits_bitwise_equal(engA, engB, ids)


def test_naive_generate_matches_engine(params):
    eng = _engine(params)
    ids = [eng.add_request(p, 6) for p in PROMPTS]
    out = eng.run()
    naive, _ = serve.naive_generate(CFG, params, [(p, 6) for p in PROMPTS],
                                    max_seq_len=32, device="cpu")
    assert naive == [out[i] for i in ids]


def test_unported_features_raise(params):
    # fp8 KV, fp8 weights and speculative decoding are ported (their tests
    # are in test_torch_serve_fp8.py); the serve telemetry is not
    for kw in (dict(fp8_kv=True), dict(fp8_weights=True), dict(spec_k=2)):
        serve.ServeEngine(CFG, params, num_pages=8, max_seq_len=64,
                          max_prompt_len=16, device="cpu", **kw)
    assert tcache.CacheConfig(num_layers=1, kv_heads=1, head_dim=8,
                              num_pages=4, page_size=8,
                              fp8=True).pool_dtype == torch.float8_e4m3fn
    with pytest.raises(NotImplementedError):
        _engine(params).serve(export_port=0)


# ---------------------------------------------------------------------------
# the scheduler (the cases of tests/test_serve.py, on the port's copy)
# ---------------------------------------------------------------------------

def _seq(i, n_prompt=6, max_new=8):
    return Sequence(seq_id=i, prompt=list(range(1, n_prompt + 1)),
                    max_new_tokens=max_new)


def test_scheduler_fcfs_admission_and_capacity():
    sched = Scheduler(num_pages=8, page_size=4, max_batch=4)
    for i in range(3):
        sched.add(_seq(i, n_prompt=6))       # needs ceil(7/4) = 2 pages
    plan = sched.schedule()
    assert [s.seq_id for s in plan.prefill] == [0, 1, 2]
    assert sched.allocator.free_pages == 1
    sched.add(_seq(3))
    plan = sched.schedule()
    assert plan.prefill == []
    assert sched.waiting[0].seq_id == 3


def test_scheduler_growth_on_page_boundary():
    sched = Scheduler(num_pages=8, page_size=4, max_batch=1)
    sched.add(_seq(0, n_prompt=6))
    (seq,) = sched.schedule().prefill
    assert len(seq.pages) == 2
    seq.tokens.extend([99, 99])              # 8 tokens: position 7 no growth
    assert sched.schedule().decode == [seq]
    assert len(seq.pages) == 2
    seq.tokens.append(99)                    # 9 tokens: position 8 -> page 3
    sched.schedule()
    assert len(seq.pages) == 3


def test_scheduler_evicts_latest_on_exhaustion_and_readmits():
    sched = Scheduler(num_pages=5, page_size=4, max_batch=2)
    a, b = _seq(0, n_prompt=6), _seq(1, n_prompt=6)
    sched.add(a)
    sched.add(b)
    assert [s.seq_id for s in sched.schedule().prefill] == [0, 1]
    assert sched.allocator.free_pages == 0
    a.tokens.extend([9, 9, 9])               # 9 tokens -> 3 pages
    plan = sched.schedule()
    assert [s.seq_id for s in plan.preempted] == [1]
    assert b.state == WAITING and b.pages == [] and b.n_preemptions == 1
    assert b.tokens == list(b.prompt)
    assert a.state == RUNNING and len(a.pages) == 3
    sched.finish(a)
    assert [s.seq_id for s in sched.schedule().prefill] == [1]


def test_scheduler_self_preempts_when_latest():
    sched = Scheduler(num_pages=5, page_size=4, max_batch=2)
    a, b = _seq(0, n_prompt=4, max_new=20), _seq(1, n_prompt=4, max_new=20)
    sched.add(a)
    sched.add(b)
    assert len(sched.schedule().prefill) == 2
    b.tokens.extend([9] * 5)
    a.tokens.append(9)
    plan = sched.schedule()
    assert b in plan.preempted and a in plan.decode


def test_scheduler_pool_too_small_raises():
    sched = Scheduler(num_pages=2, page_size=4, max_batch=1)
    sched.add(_seq(0, n_prompt=8))
    with pytest.raises(RuntimeError, match="never be admitted"):
        sched.schedule()


def test_page_allocator_invariants():
    alloc = PageAllocator(5)
    got = alloc.alloc(4)
    assert sorted(got) == [1, 2, 3, 4] and alloc.free_pages == 0
    assert alloc.alloc(1) is None
    alloc.free(got[:2])
    with pytest.raises(ValueError, match="double free"):
        alloc.free([got[0]])
    with pytest.raises(ValueError, match="invalid page"):
        alloc.free([0])


def test_serving_builds_no_autograd_graph(params, monkeypatch):
    """The GPT's parameters are trainable; every serve forward still runs
    under ``torch.no_grad()`` and returns logits with no graph."""
    seen = []
    for name in ("decode_forward", "prefill_forward", "full_forward_logits"):
        fn = getattr(tmodel, name)

        def spy(*a, _fn=fn, **kw):
            out = _fn(*a, **kw)
            logits = out[0] if isinstance(out, tuple) else out
            seen.append((torch.is_grad_enabled(), logits.requires_grad))
            return out

        monkeypatch.setattr(tmodel, name, spy)
    assert all(p.requires_grad for p in params.parameters())
    _run(params)
    serve.naive_generate(CFG, params, [(PROMPTS[0], 3)], max_seq_len=32,
                         device="cpu")
    assert len(seen) > 3
    assert all(flags == (False, False) for flags in seen)
