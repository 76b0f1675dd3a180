"""The port's ``contrib.multihead_attn`` and ``ops.softmax`` against the JAX
package, on the CPU.

The JAX modules' flax parameters go through ``params_from_jax``; the same
numpy-seeded inputs and output cotangent go through
``apex_tpu.contrib.multihead_attn`` (its fast path on the JAX flash
kernels in Pallas interpret mode, as the JAX package's own CPU tests run
them) and the port (its fast path on the plain versions, the route a CPU
tensor takes). Outputs, the input's and every parameter's gradients agree
within 1e-5 of the largest value (fp32 on both sides, sums in other
orders), over additive [sq, sk] and [b, 1, sq, sk] masks with -inf
entries, key padding, ``"causal"``, ``include_norm_add``, ``use_bias``,
``separate_qkv_params``, both impls, and sq != sk in the encoder-decoder
module; a 3-D mask raises in both packages. Attention dropout: JAX's seed
(drawn from its ``dropout`` rng) is recorded and replayed into the port's
fast path, whose keep mask is then the same bits. The softmax functions
and the rate-0 mask-softmax-dropout hold within 1e-6 with their backward;
at a rate above 0 the kept share is within binomial bounds and kept values
are scaled by ``1 / (1 - rate)``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.contrib import multihead_attn as jmha
from apex_tpu.contrib.multihead_attn import self_multihead_attn as jself_mod
from apex_tpu.contrib.multihead_attn import mask_softmax_dropout as jmsd
from apex_tpu.ops import softmax as jsm
from apex_tpu_torch.contrib import multihead_attn as tmha
from apex_tpu_torch.contrib.multihead_attn import _fused_prep
from apex_tpu_torch.contrib.multihead_attn import self_multihead_attn as \
    tself_mod
from apex_tpu_torch.ops import softmax as tsm

E, HEADS, S, B = 32, 4, 16, 2


def _inputs(seed, sq=S, sk=None):
    rng = np.random.RandomState(seed)
    x = rng.randn(sq, B, E).astype(np.float32)
    enc = None if sk is None else rng.randn(sk, B, E).astype(np.float32)
    dout = rng.randn(sq, B, E).astype(np.float32)
    return rng, x, enc, dout


def _mask(rng, kind, sq, sk):
    """An additive mask with -inf entries (never a whole row), a padding
    mask, or ``"causal"``."""
    if kind == "future":
        return np.triu(np.full((sq, sk), -np.inf, np.float32), 1)
    if kind == "batch":
        m = rng.randn(B, 1, sq, sk).astype(np.float32)
        m[rng.rand(B, 1, sq, sk) < 0.2] = -np.inf
        m[..., 0] = 0.0
        return m
    return kind


def _padding(sk):
    pad = np.zeros((B, sk), bool)
    pad[1, sk - 5:] = True
    return pad


def _flat(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _check(got, ref, what):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got.detach().numpy(), ref,
                               atol=1e-5 * max(1.0, np.abs(ref).max()),
                               rtol=0, err_msg=what)


def _compare(jmod, tcls, kwargs, x, enc, dout, call_kw, jcall_kw=None):
    """The JAX module's output and gradients (input, parameters) against
    the port's from the same parameters."""
    jx = jnp.asarray(x)
    jargs = (jx,) if enc is None else (jx, jnp.asarray(enc))
    params = jmod.init(jax.random.PRNGKey(3), *jargs,
                       is_training=False)["params"]
    jcall_kw = call_kw if jcall_kw is None else jcall_kw

    def jf(p, *a):
        return jmod.apply({"params": p}, *a, is_training=False, **jcall_kw)

    jout, vjp = jax.vjp(jf, params, *jargs)
    jgrads = vjp(jnp.asarray(dout))
    tmod = tcls.params_from_jax(E, HEADS, _flat(jax.device_get(params)),
                                device="cpu", **kwargs)
    tx = torch.from_numpy(x).requires_grad_()
    targs = (tx,) if enc is None else (tx, torch.from_numpy(enc)
                                       .requires_grad_())
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in call_kw.items()}
    out = tmod(*targs, is_training=False, **tkw)
    out.backward(torch.from_numpy(dout))
    _check(out, jout, "out")
    for i, t in enumerate(targs):
        _check(t.grad, jgrads[1 + i], f"input {i}")
    for name, p in tmod.named_parameters():
        _check(p.grad, jgrads[0][name], name)


@pytest.mark.parametrize("impl", ["fast", "default"])
@pytest.mark.parametrize("opts,mask,pad", [
    (dict(), "future", False),
    (dict(use_bias=True, include_norm_add=True), "batch", True),
    (dict(separate_qkv_params=True), "causal", True),
    (dict(use_bias=True), None, True),
])
def test_self_multihead_attn_matches_jax(impl, opts, mask, pad):
    rng, x, _, dout = _inputs(31)
    call_kw = {}
    m = _mask(rng, mask, S, S) if mask else None
    if m is not None:
        call_kw["attn_mask"] = m
    if pad:
        call_kw["key_padding_mask"] = _padding(S)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in call_kw.items()}
    _compare(jmha.SelfMultiheadAttn(E, HEADS, impl=impl, **opts),
             tmha.SelfMultiheadAttn, dict(impl=impl, **opts), x, None, dout,
             call_kw, jkw)


@pytest.mark.parametrize("impl,opts,mask,pad", [
    ("fast", dict(use_bias=True, include_norm_add=True), "batch", True),
    ("fast", dict(), "future", False),
    ("default", dict(use_bias=True), "batch", True),
])
def test_encdec_multihead_attn_matches_jax_with_sq_not_sk(impl, opts, mask,
                                                          pad):
    sq, sk = 12, 20
    rng, x, enc, dout = _inputs(32, sq, sk)
    call_kw = {"attn_mask": _mask(rng, mask, sq, sk)}
    if pad:
        call_kw["key_padding_mask"] = _padding(sk)
    jkw = {k: jnp.asarray(v) for k, v in call_kw.items()}
    _compare(jmha.EncdecMultiheadAttn(E, HEADS, impl=impl, **opts),
             tmha.EncdecMultiheadAttn, dict(impl=impl, **opts), x, enc,
             dout, call_kw, jkw)


def test_a_3d_mask_raises_in_both_packages():
    x = np.zeros((S, B, E), np.float32)
    mask = np.zeros((B, S, S), np.float32)
    jm = jmha.SelfMultiheadAttn(E, HEADS)
    with pytest.raises(ValueError, match="3-D"):
        jm.init(jax.random.PRNGKey(0), jnp.asarray(x), is_training=False,
                attn_mask=jnp.asarray(mask))
    tm = tmha.SelfMultiheadAttn(E, HEADS, device="cpu")
    with pytest.raises(ValueError, match="3-D"):
        tm(torch.from_numpy(x), attn_mask=torch.from_numpy(mask),
           is_training=False)
    te = tmha.EncdecMultiheadAttn(E, HEADS, device="cpu")
    with pytest.raises(ValueError, match="3-D"):
        te(torch.from_numpy(x), torch.from_numpy(x),
           attn_mask=torch.from_numpy(mask), is_training=False)


def test_attention_dropout_replays_the_jax_seed(monkeypatch):
    """The fast path at rate 0.3 in training (norm_add off: no output
    dropout): JAX draws its seed from the module's ``dropout`` rng, the
    port from a host generator; with JAX's seed replayed into the port's
    fast path, the kernels' hash gives the same mask and the outputs and
    gradients agree."""
    rng, x, _, dout = _inputs(33)
    pad = _padding(S)
    jm = jmha.SelfMultiheadAttn(E, HEADS, dropout=0.3, use_bias=True)
    params = jm.init(jax.random.PRNGKey(4), jnp.asarray(x),
                     is_training=False)["params"]
    seeds, jflash = [], jself_mod.flash_attention

    def record(*a, **kw):
        seeds.append(int(jax.device_get(kw["dropout_seed"])))
        return jflash(*a, **kw)

    monkeypatch.setattr(jself_mod, "flash_attention", record)

    def jf(p, xx):
        return jm.apply({"params": p}, xx, key_padding_mask=jnp.asarray(pad),
                        is_training=True, rngs={"dropout":
                                                jax.random.PRNGKey(9)})

    jout, vjp = jax.vjp(jf, params, jnp.asarray(x))
    jgrads = vjp(jnp.asarray(dout))
    assert len(set(seeds)) == 1

    prep, rates = tself_mod.prep_fast_path, []

    def replay(*a, **kw):
        sid_q, sid_kv, bias, rate, seed = prep(*a, **kw)
        rates.append(rate)
        return sid_q, sid_kv, bias, rate, seeds[0] if rate else seed

    monkeypatch.setattr(tself_mod, "prep_fast_path", replay)
    tm = tmha.SelfMultiheadAttn.params_from_jax(
        E, HEADS, _flat(jax.device_get(params)), device="cpu", dropout=0.3,
        use_bias=True)
    tx = torch.from_numpy(x).requires_grad_()
    out = tm(tx, key_padding_mask=torch.from_numpy(pad),
             generator=torch.Generator().manual_seed(0))
    out.backward(torch.from_numpy(dout))
    assert rates == [0.3]
    _check(out, jout, "out")
    _check(tx.grad, jgrads[1], "dx")
    for name, p in tm.named_parameters():
        _check(p.grad, jgrads[0][name], name)
    # the dropout moved the output: not the deterministic module's
    det = tm(tx.detach(), key_padding_mask=torch.from_numpy(pad),
             is_training=False)
    assert not torch.allclose(out.detach(), det, atol=1e-3)


def test_training_dropout_draws_from_the_host_generator():
    """The same host generator state gives the same bits (attention seed
    and output-dropout mask); another state another result; without a host
    generator a training forward with dropout raises; rate 0 or
    ``is_training=False`` draws nothing."""
    x = torch.from_numpy(_inputs(34)[1])
    tm = tmha.SelfMultiheadAttn(E, HEADS, dropout=0.2, include_norm_add=True,
                                device="cpu",
                                generator=torch.Generator().manual_seed(1))
    a = tm(x, generator=torch.Generator().manual_seed(5))
    b = tm(x, generator=torch.Generator().manual_seed(5))
    c = tm(x, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="host"):
        tm(x)
    g = torch.Generator().manual_seed(7)
    state = g.get_state()
    tm(x, is_training=False, generator=g)
    assert torch.equal(g.get_state(), state)


def test_module_options_are_checked():
    with pytest.raises(ValueError, match="divisible"):
        tmha.SelfMultiheadAttn(30, 4, device="cpu")
    with pytest.raises(ValueError, match="impl"):
        tmha.EncdecMultiheadAttn(E, HEADS, impl="fused", device="cpu")
    with pytest.raises(ValueError, match="missing"):
        tmha.SelfMultiheadAttn.params_from_jax(
            E, HEADS, {"qkv_weight": np.zeros((3 * E, E), np.float32)},
            device="cpu")
    names = [n for n, _ in tmha.SelfMultiheadAttn(
        E, HEADS, separate_qkv_params=True, use_bias=True,
        device="cpu").named_parameters()]
    # the JAX module has no q/k/v biases with separate parameters
    assert names == ["q_weight", "k_weight", "v_weight", "out_proj_weight",
                     "out_proj_bias"]


def test_prep_fast_path_builds_the_kernel_operands():
    pad = torch.zeros(B, 20, dtype=torch.bool)
    pad[0, 15:] = True
    mask = torch.zeros(12, 20)
    sid_q, sid_kv, bias, rate, seed = _fused_prep.prep_fast_path(
        pad, mask, B, 12, 0.1, True, None)
    assert sid_q.dtype == sid_kv.dtype == torch.int32
    assert tuple(sid_q.shape) == (B, 12) and int(sid_q.abs().sum()) == 0
    assert sid_kv[0, 15:].eq(-1).all() and sid_kv[1].eq(0).all()
    assert tuple(bias.shape) == (1, 1, 12, 20) and rate == 0.0
    assert seed is None
    _, _, bias, rate, seed = _fused_prep.prep_fast_path(
        None, "causal", B, 12, 0.1, False, torch.Generator().manual_seed(0),
        causal=True)
    assert bias is None and rate == 0.1 and 0 <= seed < 2 ** 31 - 1


# ---------------------------------------------------------------------------
# ops.softmax and the mask-softmax-dropout
# ---------------------------------------------------------------------------

def _softmax_inputs(seed, shape=(2, 3, 8, 12)):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32), rng)


@pytest.mark.parametrize("with_mask", [False, True])
def test_scaled_masked_softmax_and_backward_match_jax(with_mask):
    x, dy, rng = _softmax_inputs(41)
    mask = (rng.rand(2, 1, 1, 12) < 0.3) if with_mask else None
    jy, vjp = jax.vjp(lambda a: jsm.scaled_masked_softmax(
        a, None if mask is None else jnp.asarray(mask), 0.7), jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(dy))
    tx = torch.from_numpy(x).requires_grad_()
    y = tsm.scaled_masked_softmax(
        tx, None if mask is None else torch.from_numpy(mask), 0.7)
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), atol=1e-6)


@pytest.mark.parametrize("sq,sk", [(8, 8), (6, 12)])
def test_scaled_upper_triang_masked_softmax_matches_jax(sq, sk):
    x, dy, _ = _softmax_inputs(42, (3, sq, sk))
    jy, vjp = jax.vjp(lambda a: jsm.scaled_upper_triang_masked_softmax(
        a, 0.5), jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(dy))
    tx = torch.from_numpy(x).requires_grad_()
    y = tsm.scaled_upper_triang_masked_softmax(tx, 0.5)
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), atol=1e-6)


def test_softmax_keeps_the_input_dtype():
    x = torch.randn(2, 8, 8).bfloat16().requires_grad_()
    y = tsm.scaled_upper_triang_masked_softmax(x, 1.0)
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16
    assert tsm.scaled_masked_softmax(x.detach().half(), None,
                                     1.0).dtype == torch.float16


def test_mask_softmax_dropout_at_rate_0_matches_jax():
    x, dy, rng = _softmax_inputs(43)
    pad = rng.rand(2, 1, 1, 12) < 0.25
    jy, vjp = jax.vjp(lambda a: jmsd.fast_mask_softmax_dropout(
        a, jnp.asarray(pad), scale=0.9), jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(dy))
    tx = torch.from_numpy(x).requires_grad_()
    y = tmha.MaskSoftmaxDropout(0.0, 0.9)(tx, torch.from_numpy(pad))
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), atol=1e-6)


def test_mask_softmax_dropout_keeps_its_share_and_scales():
    rate = 0.25
    x = torch.randn(4, 8, 64, 64).requires_grad_()
    g = torch.Generator().manual_seed(0)
    y = tmha.fast_mask_softmax_dropout(x, dropout_prob=rate, generator=g)
    p = tsm.scaled_masked_softmax(x.detach(), None, 1.0)
    kept = y.detach() != 0
    n = kept.numel()
    share = kept.float().mean().item()
    assert abs(share - (1 - rate)) <= 5 * (rate * (1 - rate) / n) ** 0.5
    torch.testing.assert_close(y.detach()[kept], p[kept] / (1 - rate))
    # the backward goes through the kept elements only (the saved mask)
    y.backward(torch.ones_like(y))
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    with pytest.raises(ValueError, match="Generator"):
        tmha.fast_mask_softmax_dropout(x, dropout_prob=rate)
    # inference draws nothing and drops nothing
    assert torch.equal(tmha.fast_mask_softmax_dropout(
        x.detach(), dropout_prob=rate, is_training=False), p)


def test_importing_the_modules_loads_no_jax_and_builds_nothing():
    """Like the port's other entry points (tests/test_torch_isolation.py):
    the new modules import no jax, flax or apex_tpu, no triton, and build
    no kernel at import."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    code = (
        "import sys, json\n"
        "import apex_tpu_torch.contrib.multihead_attn\n"
        "import apex_tpu_torch.ops.softmax\n"
        "from apex_tpu_torch.ops import _build\n"
        "print(json.dumps({'jax': sorted(m for m in sys.modules if "
        "m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'apex_tpu')), "
        "'triton': 'triton' in sys.modules, 'loaded': sorted(_build._LIBS)}"
        "))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(root),
                         env=dict(os.environ, PYTHONPATH=str(root)),
                         capture_output=True, text=True, timeout=120,
                         check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"jax": [], "triton": False, "loaded": []}


def test_modules_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (tmha.SelfMultiheadAttn, tmha.EncdecMultiheadAttn):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(E, HEADS)
