"""apex_tpu_torch's fp8 serving (fp8 KV, fp8 weight streaming) and
speculative decoding against apex_tpu.serve on a tiny GPT.

The model (2 layers, h64, 4 heads, V256) is initialised by flax and carried
across with ``GPT.params_from_jax``; inputs are made with numpy from a seed.
Both sides run fp32 on the CPU (the port through its kernels' plain
versions, JAX through its reference paths). Tolerances: the fp8 cache
writes and the weight quantization are bitwise (the same codec on the same
fp32 inputs; e4m3 compared as bytes); fp8 forwards within 2e-4 of JAX (fp32
through two blocks in another summation order, the e4m3 encodings equal);
fp8 KV against the full-precision cache within 0.15 of the largest logit,
teacher-forced (``tests/test_serve.py``'s bound); the port's own contracts
(preempt/resume, speculative against plain decode) bitwise.
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
from apex_tpu.serve import spec as jspec
from apex_tpu.transformer import parallel_state as ps
from apex_tpu_torch import serve
from apex_tpu_torch.models.gpt import GPT, GPTConfig
from apex_tpu_torch.ops import flash_attention as tfa
from apex_tpu_torch.ops import fp8_matmul as tmm
from apex_tpu_torch.serve import cache as tcache
from apex_tpu_torch.serve import model as tmodel
from apex_tpu_torch.serve import spec as tspec

SHAPE = dict(vocab_size=256, max_seq_len=128, hidden_size=64, num_layers=2,
             num_heads=4)
JCFG = JGPTConfig(dtype=jnp.float32, **SHAPE)
CFG = GPTConfig(dtype=torch.float32, **SHAPE)
PROMPTS = [[5, 9, 17, 3, 40, 22, 8, 200, 131],
           [11, 2, 33, 60, 7, 7, 1, 250, 99, 18, 64]]
TAIL = [14, 3, 59, 22, 8, 41, 30, 7]
N_NEW = 12
LOGIT_TOL = 2e-4


@pytest.fixture(scope="module")
def jparams():
    ps.destroy_model_parallel()
    return JGPT(JCFG).init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def params(jparams):
    return GPT.params_from_jax(CFG, jax.device_get(jparams), device="cpu")


def _engine_kw(max_batch=4, num_pages=32):
    return dict(num_pages=num_pages, max_seq_len=64, max_prompt_len=16,
                page_size=8, max_batch=max_batch, record_logits=True)


def _run(params, *, preempt_at=None, max_batch=4, num_pages=32, **kw):
    eng = serve.ServeEngine(CFG, params, device="cpu",
                            **_engine_kw(max_batch, num_pages), **kw)
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


def _assert_logits_bitwise_equal(engA, engB, ids):
    for sid in ids:
        la, lb = engA.logits_log[sid], engB.logits_log[sid]
        assert set(la) == set(lb), (sid, sorted(la), sorted(lb))
        for pos in la:
            assert np.array_equal(la[pos], lb[pos]), (sid, pos)


def _bytes(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.view(torch.uint8).numpy()
    return np.asarray(t).view(np.uint8)


def _ccfgs(**kw):
    return (jcache.CacheConfig(dtype=jnp.float32, **kw),
            tcache.CacheConfig(dtype=torch.float32, **kw))


def _assert_fp8_state_equal(jstate, tstate, live_pages):
    """Pools as bytes and scales as bits, on the live pages (the null page
    takes masked writes in an order neither side defines)."""
    live = np.asarray(live_pages)
    for j, t in ((jstate.k_pool, tstate.k_pool),
                 (jstate.v_pool, tstate.v_pool)):
        assert t.dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(_bytes(t)[:, :, live],
                                      _bytes(j)[:, :, live])
    for j, t in ((jstate.k_scale, tstate.k_scale),
                 (jstate.v_scale, tstate.v_scale)):
        np.testing.assert_array_equal(
            t.numpy()[:, :, live].view(np.uint32),
            np.asarray(j)[:, :, live].view(np.uint32))


# ---------------------------------------------------------------------------
# the fp8 pool: accounting and the slot-0 scale rule
# ---------------------------------------------------------------------------

def test_fp8_capacity_accounting_matches_jax():
    common = dict(num_layers=12, kv_heads=16, head_dim=64, num_pages=256,
                  page_size=128)
    jb = jcache.CacheConfig(dtype=jnp.bfloat16, **common)
    tb = tcache.CacheConfig(dtype=torch.bfloat16, **common)
    j8 = jcache.CacheConfig(fp8=True, **common)
    t8 = tcache.CacheConfig(fp8=True, **common)
    assert t8.pool_dtype == torch.float8_e4m3fn and t8.fp8_margin == 2.0
    budget = tb.pool_bytes()
    for j, t in ((jb, tb), (j8, t8)):
        assert t.bytes_per_page() == j.bytes_per_page()
        assert t.pool_bytes() == j.pool_bytes()
        assert t.usable_pages == j.usable_pages
        assert t.pages_for_tokens(300) == j.pages_for_tokens(300)
        assert t.pages_in_budget(budget) == j.pages_in_budget(budget)
        assert t.occupancy_bytes(17) == j.occupancy_bytes(17)
        for seq_len in (1, 128, 1024):
            assert t.max_concurrent_seqs(budget, seq_len) == \
                j.max_concurrent_seqs(budget, seq_len)
    assert t8.bytes_per_page() / tb.bytes_per_page() <= 0.55
    assert t8.max_concurrent_seqs(budget, 1024) >= \
        2 * tb.max_concurrent_seqs(budget, 1024)


def test_init_cache_fp8_scales_are_two_tensors():
    _, tc = _ccfgs(num_layers=2, kv_heads=2, head_dim=8, num_pages=5,
                   page_size=4, fp8=True)
    st = tcache.init_cache(tc, device="cpu")
    assert st.k_pool.dtype == torch.float8_e4m3fn
    assert st.k_scale.shape == (2, 2, 5) and st.k_scale.dtype == torch.float32
    assert bool((st.k_scale == 1).all()) and bool((st.v_scale == 1).all())
    assert st.k_scale.data_ptr() != st.v_scale.data_ptr()
    plain = tcache.init_cache(_ccfgs(num_layers=1, kv_heads=1, head_dim=8,
                                     num_pages=2, page_size=4)[1],
                              device="cpu")
    assert plain.k_scale is None and plain.v_scale is None


@pytest.mark.parametrize("margin", [2.0, 0.0])
def test_fp8_writes_match_jax_bitwise(margin):
    """A prompt write, then 8 decode writes that cross two page boundaries,
    with inactive slots routed to the null page: pools and scales equal to
    the JAX cache's, bit for bit, on every live page."""
    kw = dict(num_layers=2, kv_heads=2, head_dim=8, num_pages=8, page_size=4,
              fp8=True, fp8_margin=margin)
    jc, tc = _ccfgs(**kw)
    jstate = jcache.init_cache(jc)
    tstate = tcache.init_cache(tc, device="cpu")
    rng = np.random.RandomState(int(margin) + 1)
    bt = np.asarray([3, 6, 2, 5], np.int32)
    S, length = 10, 6                         # positions 6..9 -> null page
    k_seq = (rng.randn(S, 2, 8) * 3).astype(np.float32)
    v_seq = (rng.randn(S, 2, 8) * 0.1).astype(np.float32)
    for layer in (0, 1):
        jstate = jcache.write_prompt(jc, jstate, layer, jnp.asarray(bt),
                                     jnp.int32(length), jnp.asarray(k_seq),
                                     jnp.asarray(v_seq))
        tcache.write_prompt(tc, tstate, layer, torch.from_numpy(bt), length,
                            torch.from_numpy(k_seq), torch.from_numpy(v_seq))
    _assert_fp8_state_equal(jstate, tstate, bt)
    for step in range(8):                     # positions 6..13: pages 1..3
        pos = length + step
        page_ids = np.asarray([bt[pos // 4], 0, 0], np.int32)
        slots = np.asarray([pos % 4, 0, 0], np.int32)
        # later tokens larger than slot 0's: the saturating clip bites
        k_new = (rng.randn(3, 2, 8) * (1 + step)).astype(np.float32)
        v_new = (rng.randn(3, 2, 8) * 0.1).astype(np.float32)
        for layer in (0, 1):
            jstate = jcache.write_token(jc, jstate, layer,
                                        jnp.asarray(page_ids),
                                        jnp.asarray(slots),
                                        jnp.asarray(k_new),
                                        jnp.asarray(v_new))
            out = tcache.write_token(tc, tstate, layer,
                                     torch.from_numpy(page_ids),
                                     torch.from_numpy(slots),
                                     torch.from_numpy(k_new),
                                     torch.from_numpy(v_new))
            assert out is tstate                               # in place
        _assert_fp8_state_equal(jstate, tstate, bt)
    # the scale of every touched page came from its slot-0 token
    assert not bool((tstate.k_scale[:, :, bt[:4]] == 1).any())
    assert not bool(torch.isnan(tstate.k_pool.float()).any())


# ---------------------------------------------------------------------------
# fp8 weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("margin", [0.0, 1.0])
def test_quantize_gpt_weights_matches_jax_bitwise(jparams, params, margin):
    jq = jmodel.quantize_gpt_weights(JCFG, jparams, margin=margin)
    before = {n: p.detach().clone() for n, p in params.named_parameters()}
    tq = tmodel.quantize_gpt_weights(CFG, params, margin=margin)
    for i in range(CFG.num_layers):
        for group, name in tmodel._FP8_WEIGHT_LINEARS:
            j = jq[f"block_{i}"][group][name]
            t = getattr(getattr(tq.block(i), group), name)
            assert t.kernel.dtype == torch.float8_e4m3fn
            np.testing.assert_array_equal(_bytes(t.kernel),
                                          _bytes(j["kernel"]))
            assert t.scale.shape == ()
            assert t.scale.numpy().view(np.uint32) == \
                np.asarray(j["scale"]).view(np.uint32)
            # the bias is the module's own tensor, not a copy
            assert t.bias is getattr(getattr(params.block(i), group),
                                     name).bias
    # the caller's GPT is left as it was; the shared leaves are shared
    for n, p in params.named_parameters():
        assert torch.equal(p, before[n]), n
    assert tq.wte is params.wte and tq.ln_f is params.ln_f
    assert tq.block(0).ln1 is params.block(0).ln1
    assert tmodel.weight_stream_bytes(CFG, tq) == \
        jmodel.weight_stream_bytes(JCFG, jq)
    assert tmodel.weight_stream_bytes(CFG, params) == \
        jmodel.weight_stream_bytes(JCFG, jparams)
    # e4m3 kernels plus fp32 scales: about a quarter of the fp32 tree
    ratio = (tmodel.weight_stream_bytes(CFG, tq)
             / tmodel.weight_stream_bytes(CFG, params))
    assert 0.2 < ratio <= 0.275, ratio


def _forced(cfg_pair, params_pair, fp8_kv, tail=TAIL):
    """Teacher-forced prefill of PROMPTS[0] then decodes of ``tail`` on both
    sides; returns (jax rows, port rows, jax state, port state)."""
    (jcfg, tcfg), (jp, tp) = cfg_pair, params_pair
    kw = dict(num_layers=SHAPE["num_layers"], kv_heads=SHAPE["num_heads"],
              head_dim=SHAPE["hidden_size"] // SHAPE["num_heads"],
              num_pages=8, page_size=8, fp8=fp8_kv)
    jc, tc = _ccfgs(**kw)
    jstate = jcache.init_cache(jc)
    tstate = tcache.init_cache(tc, device="cpu")
    prompt = PROMPTS[0]
    ids = np.asarray(prompt + [0] * (16 - len(prompt)), np.int32)
    bt = np.asarray([1, 2, 3], np.int32)
    # slot 2 inactive: its rows are garbage and its writes hit the null page
    bts = np.asarray([[1, 2, 3], [0, 0, 0]], np.int32)
    jrows, trows = [], []
    jl, jstate = jmodel.prefill_forward(
        jcfg, jc, jp, jstate, jnp.asarray(bt), jnp.int32(len(prompt)),
        jnp.asarray(ids))
    with torch.no_grad():
        tl, _ = tmodel.prefill_forward(tcfg, tc, tp, tstate,
                                       torch.from_numpy(bt), len(prompt),
                                       torch.from_numpy(ids).long())
    jrows.append(np.asarray(jl))
    trows.append(tl.numpy())
    for j, tok in enumerate(tail):
        pos = np.asarray([len(prompt) + j, 0], np.int32)
        toks = np.asarray([tok, 0], np.int32)
        act = np.asarray([True, False])
        jl, jstate = jmodel.decode_forward(
            jcfg, jc, jp, jstate, jnp.asarray(bts), jnp.asarray(pos),
            jnp.asarray(toks), jnp.asarray(act))
        with torch.no_grad():
            tl, _ = tmodel.decode_forward(
                tcfg, tc, tp, tstate, torch.from_numpy(bts),
                torch.from_numpy(pos).long(), torch.from_numpy(toks).long(),
                torch.from_numpy(act))
        jrows.append(np.asarray(jl)[0])
        trows.append(tl.numpy()[0])
    return jrows, trows, jstate, tstate


@pytest.mark.parametrize("fp8_kv,fp8_w", [(True, False), (False, True),
                                          (True, True)])
def test_fp8_forwards_match_jax(jparams, params, fp8_kv, fp8_w):
    jp, tp = jparams, params
    if fp8_w:
        jp = jmodel.quantize_gpt_weights(JCFG, jparams)
        tp = tmodel.quantize_gpt_weights(CFG, params)
    jrows, trows, jstate, tstate = _forced((JCFG, CFG), (jp, tp), fp8_kv)
    for i, (j, t) in enumerate(zip(jrows, trows)):
        np.testing.assert_allclose(t, j, atol=LOGIT_TOL, rtol=0,
                                   err_msg=f"row {i}")
    if fp8_kv:
        live = np.asarray([1, 2])             # 9 + 8 = 17 positions
        for j, t in ((jstate.k_scale, tstate.k_scale),
                     (jstate.v_scale, tstate.v_scale)):
            np.testing.assert_allclose(t.numpy()[:, :, live],
                                       np.asarray(j)[:, :, live], rtol=1e-5)


def test_fp8_kv_teacher_forced_against_full_precision(jparams, params):
    """The port's fp8 KV against its own full-precision cache, over fp8
    weights on both: the bound ``tests/test_serve.py`` holds the JAX cache
    to."""
    tp = tmodel.quantize_gpt_weights(CFG, params)
    jp = jmodel.quantize_gpt_weights(JCFG, jparams)
    _, exact, _, _ = _forced((JCFG, CFG), (jp, tp), False)
    _, quant, _, _ = _forced((JCFG, CFG), (jp, tp), True)
    worst = max(float(np.max(np.abs(a - b))) for a, b in zip(exact, quant))
    mag = max(float(np.max(np.abs(a))) for a in exact)
    assert worst < 0.15 * max(mag, 1.0), (worst, mag)
    assert worst > 0                   # the fp8 pool really was used


def test_full_forward_reference_serves_the_quantized_weights(params):
    """``full_forward_logits(reference=True)`` over the quantized view runs
    the dequant-matmul's plain version: equal to the kernel path's CPU
    result, and away from the unquantized model's logits."""
    tq = tmodel.quantize_gpt_weights(CFG, params)
    rng = np.random.RandomState(4)
    ids = torch.from_numpy(rng.randint(0, 256, (3, 20))).long()
    lengths = torch.tensor([20, 5, 13])
    with torch.no_grad():
        ref = tmodel.full_forward_logits(CFG, tq, ids, lengths,
                                         reference=True)
        ker = tmodel.full_forward_logits(CFG, tq, ids, lengths)
        full = tmodel.full_forward_logits(CFG, params, ids, lengths,
                                          reference=True)
    np.testing.assert_allclose(ref.numpy(), ker.numpy(), atol=1e-5, rtol=0)
    assert float((ref - full).abs().max()) > 1e-4


# ---------------------------------------------------------------------------
# the engine with fp8 KV and fp8 weights
# ---------------------------------------------------------------------------

def test_fp8_engine_matches_jax_engine(jparams, params):
    jeng = jserve.ServeEngine(JCFG, jparams, fp8_kv=True, fp8_weights=True,
                              **_engine_kw())
    jids = [jeng.add_request(p, N_NEW) for p in PROMPTS]
    jout = jeng.run()
    launches = (tmm.fp8_dequant_matmul.launches,
                tfa.paged_decode_attention.launches,
                tfa.paged_decode_attention.fp8_launches)
    eng, ids, out, _ = _run(params, fp8_kv=True, fp8_weights=True)
    # on the CPU the wrappers take the plain versions and count nothing
    assert launches == (tmm.fp8_dequant_matmul.launches,
                        tfa.paged_decode_attention.launches,
                        tfa.paged_decode_attention.fp8_launches)
    assert eng.state.k_pool.dtype == torch.float8_e4m3fn
    assert eng.params.block(0).attn.qkv.kernel.dtype == torch.float8_e4m3fn
    assert [out[i] for i in ids] == [jout[i] for i in jids]
    worst = max(float(np.max(np.abs(eng.logits_log[i][p]
                                    - jeng.logits_log[j][p])))
                for i, j in zip(ids, jids) for p in jeng.logits_log[j])
    assert worst < LOGIT_TOL, worst
    assert eng.sched.allocator.free_pages == eng.ccfg.num_pages - 1


@pytest.mark.parametrize("preempt", ["forced", "organic"])
def test_fp8_engine_preempt_resume_bit_exact(params, preempt):
    kw = dict(fp8_kv=True, fp8_weights=True)
    engA, ids, outA, _ = _run(params, **kw)
    if preempt == "forced":
        engB, _, outB, n_pre = _run(params, preempt_at=5, **kw)
    else:
        engB, _, outB, n_pre = _run(params, num_pages=6, **kw)
    assert n_pre >= 1
    assert outA == outB
    _assert_logits_bitwise_equal(engA, engB, ids)


# ---------------------------------------------------------------------------
# speculative decoding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draft,verify", [
    ([], [7]), ([1, 2, 3], [9, 8, 7, 6]), ([1, 2, 3], [1, 2, 3, 4]),
    ([5, 9, 9], [5, 2, 9, 9]), ([np.int32(5)], np.asarray([5, 6], np.int32)),
])
def test_accept_greedy_matches_jax(draft, verify):
    got = tspec.accept_greedy(draft, verify)
    assert got == jspec.accept_greedy(draft, verify)
    assert all(type(t) is int for t in got[0])
    with pytest.raises(ValueError, match="argmaxes"):
        tspec.accept_greedy(draft, list(verify)[:-1])


def test_derive_draft_matches_jax(jparams, params):
    jdcfg, jdp = jspec.derive_draft(JCFG, jparams, num_layers=1)
    dcfg, dp = tspec.derive_draft(CFG, params, num_layers=1)
    assert dcfg.num_layers == jdcfg.num_layers == 1
    assert dcfg.hidden_size == jdcfg.hidden_size
    assert len(dp.blocks) == len([k for k in jdp if k.startswith("block_")])
    # no new weights: the draft holds the target's modules
    assert dp.block(0) is params.block(0) and dp.wte is params.wte
    assert dp.ln_f is params.ln_f and dp.wpe is params.wpe
    tq = tmodel.quantize_gpt_weights(CFG, params)
    _, dq = tspec.derive_draft(CFG, tq, num_layers=1)
    assert dq.block(0) is tq.block(0)
    for bad in (0, -1, CFG.num_layers + 1):
        with pytest.raises(ValueError, match="num_layers"):
            tspec.derive_draft(CFG, params, num_layers=bad)


@pytest.mark.parametrize("fp8_weights,spec_k,layers", [
    (True, 3, None), (True, 2, 2), (False, 3, 1)])
def test_spec_matches_plain_decode_bitwise(params, fp8_weights, spec_k,
                                           layers):
    """Speculative output equals plain decode token for token and logits
    row for logits row; with the full-depth draft every proposal is
    accepted and the verify calls are fewer than the decode steps."""
    engP, ids, outP, _ = _run(params, fp8_weights=fp8_weights)
    engS, idsS, outS, _ = _run(params, fp8_weights=fp8_weights,
                               spec_k=spec_k, draft_num_layers=layers)
    assert ids == idsS and outP == outS
    _assert_logits_bitwise_equal(engP, engS, ids)
    if fp8_weights:
        assert engS.draft_params.block(0) is engS.params.block(0)
    assert engS.accepted_tokens + engS.spec_rounds == \
        sum(len(v) for v in outS.values()) - len(PROMPTS)
    assert engS.draft_tokens >= engS.accepted_tokens
    if layers == CFG.num_layers:
        assert engS.accepted_tokens == engS.draft_tokens
        assert len(engS.decode_step_times) < len(engP.decode_step_times)
    assert all(s.draft_cached == 0 for s in engS.seqs.values())


def test_spec_tokens_match_jax_spec_engine(jparams, params):
    jeng = jserve.ServeEngine(JCFG, jparams, fp8_weights=True, spec_k=3,
                              **_engine_kw())
    jids = [jeng.add_request(p, N_NEW) for p in PROMPTS]
    jout = jeng.run()
    eng, ids, out, _ = _run(params, fp8_weights=True, spec_k=3)
    assert [out[i] for i in ids] == [jout[i] for i in jids]


def test_spec_preempt_resume_bit_exact(params):
    engS, ids, outS, _ = _run(params, fp8_weights=True, spec_k=3)
    engR, _, outR, n_pre = _run(params, fp8_weights=True, spec_k=3,
                                preempt_at=3)
    assert n_pre >= 1
    assert outS == outR
    _assert_logits_bitwise_equal(engS, engR, ids)


def test_explicit_draft_params_are_quantized_too(jparams, params):
    dcfg = GPTConfig(dtype=torch.float32, **dict(SHAPE, num_layers=1))
    draft = GPT.init_params(dcfg, torch.Generator().manual_seed(1),
                            device="cpu")
    eng = serve.ServeEngine(CFG, params, device="cpu", fp8_weights=True,
                            spec_k=2, draft_cfg=dcfg, draft_params=draft,
                            **_engine_kw())
    assert eng.draft_params.block(0).mlp.fc1.kernel.dtype == \
        torch.float8_e4m3fn
    assert draft.block(0).mlp.fc1.kernel.dtype == torch.float32
    # the draft pool mirrors the target's geometry
    assert (eng.draft_ccfg.num_pages, eng.draft_ccfg.page_size) == \
        (eng.ccfg.num_pages, eng.ccfg.page_size)
    assert eng.draft_ccfg.num_layers == 1 and not eng.draft_ccfg.fp8
    ids = [eng.add_request(p, 6) for p in PROMPTS]
    out = eng.run()
    plain = serve.ServeEngine(CFG, params, device="cpu", fp8_weights=True,
                              **_engine_kw())
    pids = [plain.add_request(p, 6) for p in PROMPTS]
    pout = plain.run()
    assert [out[i] for i in ids] == [pout[i] for i in pids]


@pytest.mark.parametrize("kw,match", [
    (dict(spec_k=-1), ">= 0"),
    (dict(spec_k=4, max_batch=4), "max_batch"),
    (dict(spec_k=2, fp8_kv=True), "fp8_kv"),
    (dict(spec_k=2, draft_params="params"), "draft_cfg"),
])
def test_engine_refusals_match_jax(jparams, params, kw, match):
    kw = dict(kw)
    max_batch = kw.pop("max_batch", 4)
    tkw, jkw = dict(kw), dict(kw)
    if kw.get("draft_params") == "params":
        tkw["draft_params"], jkw["draft_params"] = params, jparams
    with pytest.raises(ValueError, match=match):
        jserve.ServeEngine(JCFG, jparams, **_engine_kw(max_batch), **jkw)
    with pytest.raises(ValueError, match=match):
        serve.ServeEngine(CFG, params, device="cpu",
                          **_engine_kw(max_batch), **tkw)
