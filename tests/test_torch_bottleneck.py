"""The port's fused bottleneck (B15), ``SyncBatchNorm``, ``halo_exchange``
and ``SpatialBottleneck`` against the JAX package on the CPU, world 1.

- ``apex_tpu_torch.scripts.bottleneck_proto`` against the JAX script
  ``scripts/bottleneck_proto.py``: ``make_params`` bitwise; the plain
  version against the script's Pallas kernel (``pallas_block`` with
  ``pl.pallas_call`` run in interpret mode; the script is not edited, the
  test swaps its module's ``pl`` for one whose ``pallas_call`` interprets)
  at N = 1 in bf16, and against ``xla_block`` in bf16 and fp32;
- ``SyncBatchNorm`` against the JAX module with ``axis_name=None`` (the
  same function at world 1): train and eval, running statistics, ``z``
  and ``fuse_relu``, in NCHW and channel-last;
- ``halo_exchange`` and ``SpatialBottleneck`` against the JAX module under
  a one-device ``shard_map``, parameters carried over with
  ``SpatialBottleneck.params_from_jax``.

Tolerances: bf16 blocks within two bf16 ulps of the reference plus 2^-7,
with at most 0.1 % of elements differing (both sides sum exact fp32
products in another order, so a sum near a bf16 rounding boundary of h1,
h2 or the output can round the other way; read 0.0078 on 0.012 % of
elements); fp32 blocks within 1e-5 of the largest output (summation
order); the batch norm within 1e-5 (outputs) and 1e-6 (statistics) of the
largest value (fp32 sums in another order); the spatial bottleneck's
outputs and gradients within 1e-4 of the largest value (flax's and
torch's fp32 convolutions sum in other orders).
"""

import functools
import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu._compat import shard_map
from apex_tpu.contrib.bottleneck import (SpatialBottleneck as JaxSpatial,
                                         halo_exchange as jax_halo)
from apex_tpu.parallel.sync_batchnorm import SyncBatchNorm as JaxSyncBN
from apex_tpu_torch.contrib.bottleneck import (Bottleneck, SpatialBottleneck,
                                               halo_exchange)
from apex_tpu_torch.models import resnet as port_resnet
from apex_tpu_torch.parallel import (SyncBatchNorm, convert_syncbn_model,
                                     create_syncbn_process_group)
from apex_tpu_torch.scripts import bottleneck_proto as bp

ROOT = Path(__file__).resolve().parent.parent


@functools.lru_cache(maxsize=None)
def _proto():
    spec = importlib.util.spec_from_file_location(
        "bottleneck_proto_script", ROOT / "scripts" / "bottleneck_proto.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _interpreting(pl):
    """A stand-in for the ``pallas`` module whose ``pallas_call``
    interprets."""
    ns = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl)
                                  if not k.startswith("__")})
    ns.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    return ns


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close_bf16(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    diff = np.abs(got - ref)
    assert (diff <= np.abs(ref) * 2.0 ** -7 + 2.0 ** -7).all(), diff.max()
    assert (diff > 0).mean() <= 1e-3, (diff > 0).mean()


# ---------------------------------------------------------------------------
# B15: the fused bottleneck's plain version
# ---------------------------------------------------------------------------

def test_make_params_are_the_protos_numbers():
    proto = _proto()
    for dtype_j, dtype_t in ((jnp.bfloat16, torch.bfloat16),
                             (jnp.float32, torch.float32)):
        pj, pt = proto.make_params(dtype_j), bp.make_params(dtype_t, device="cpu")
        assert sorted(pj) == sorted(pt) == sorted(bp.PARAM_NAMES)
        for k in pj:
            assert np.array_equal(_f32(pj[k]), pt[k].float().numpy()), k
    xj = jnp.asarray(np.random.RandomState(1).randn(1, 56, 56, 256) * 0.5,
                     jnp.bfloat16)
    assert np.array_equal(_f32(xj), bp.make_input(1, device="cpu").float().numpy())
    assert (bp.N, bp.H, bp.W, bp.C, bp.S) == (proto.N, proto.H, proto.W,
                                              proto.C, proto.S)


def test_plain_block_matches_the_pallas_kernel(monkeypatch):
    proto = _proto()
    monkeypatch.setattr(proto, "pl", _interpreting(proto.pl))
    p = proto.make_params()
    x = bp.make_input(1, device="cpu")
    y_pallas = proto.pallas_block(jnp.asarray(x.float().numpy(),
                                              jnp.bfloat16), p)
    got = bp.fused_block(x, bp.make_params(device="cpu"))       # CPU: the plain version
    assert got.dtype == torch.bfloat16 and got.shape == (1, 56, 56, 256)
    _close_bf16(got.float().numpy(), _f32(y_pallas))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_plain_block_matches_xla_block(dtype):
    proto = _proto()
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    x = bp.make_input(1, dtype=td, device="cpu")
    ref = _f32(proto.xla_block(jnp.asarray(x.float().numpy(), jd),
                               proto.make_params(jd)))
    got = bp.plain_block(x, bp.make_params(td, device="cpu"))
    assert got.dtype == td
    got = got.float().numpy()
    if dtype == "bfloat16":
        _close_bf16(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# SyncBatchNorm at world 1
# ---------------------------------------------------------------------------

def _jax_bn(x_nhwc, z, fuse_relu, train, stats=None, weight=None,
            bias=None):
    mod = JaxSyncBN(num_features=x_nhwc.shape[-1], axis_name=None,
                    fuse_relu=fuse_relu, momentum=0.1)
    v = mod.init(jax.random.PRNGKey(0), x_nhwc)
    v = jax.tree.map(np.asarray, v)
    if stats is not None:
        v["batch_stats"] = stats
    if weight is not None:
        v["params"] = {"weight": weight, "bias": bias}
    y, new = mod.apply(v, x_nhwc, z=z, use_running_average=not train,
                       mutable=["batch_stats"])
    return np.asarray(y), jax.tree.map(np.asarray, new["batch_stats"])


@pytest.mark.parametrize("channel_last", [False, True])
@pytest.mark.parametrize("with_z,fuse_relu", [(False, False), (True, True),
                                              (False, True)])
def test_sync_batchnorm_matches_jax(channel_last, with_z, fuse_relu):
    rng = np.random.RandomState(3)
    x = (rng.randn(4, 5, 6, 8) * 2 + 1).astype(np.float32)      # NHWC
    z = rng.randn(4, 5, 6, 8).astype(np.float32) if with_z else None
    w = (1 + 0.1 * rng.randn(8)).astype(np.float32)
    b = (0.1 * rng.randn(8)).astype(np.float32)
    stats = {"mean": (0.1 * rng.randn(8)).astype(np.float32),
             "var": (1 + 0.1 * rng.rand(8)).astype(np.float32)}
    bn = SyncBatchNorm(8, fuse_relu=fuse_relu, channel_last=channel_last,
                       device="cpu")
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))

    def port(a):
        t = torch.from_numpy(a)
        return t if channel_last else t.permute(0, 3, 1, 2).contiguous()

    def back(t):
        t = t.detach()
        return (t if channel_last else t.permute(0, 2, 3, 1)).numpy()

    for train in (True, False):
        y_ref, st_ref = _jax_bn(jnp.asarray(x), None if z is None
                                else jnp.asarray(z), fuse_relu, train,
                                {k: bn_v for k, bn_v in
                                 (("mean", bn.running_mean.numpy().copy()),
                                  ("var", bn.running_var.numpy().copy()))},
                                w, b)
        bn.train(train)
        y = bn(port(x), None if z is None else port(z))
        scale = np.abs(y_ref).max()
        np.testing.assert_allclose(back(y), y_ref, rtol=0, atol=1e-5 * scale)
        np.testing.assert_allclose(bn.running_mean.numpy(), st_ref["mean"],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(), st_ref["var"],
                                   rtol=0, atol=1e-6 * np.abs(
                                       st_ref["var"]).max())


def test_sync_batchnorm_keeps_dtype_and_converts_torch_batchnorm():
    bn = SyncBatchNorm(4, device="cpu")
    x = torch.randn(2, 4, 3, 3).to(torch.bfloat16)
    assert bn(x).dtype == torch.bfloat16
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 1),
                              torch.nn.Sequential(torch.nn.BatchNorm2d(4,
                                                                       momentum=0.3)))
    with torch.no_grad():
        net[1][0].running_mean.fill_(0.5)
    net = convert_syncbn_model(net)
    new = net[1][0]
    assert isinstance(new, SyncBatchNorm) and new.momentum == 0.3
    assert float(new.running_mean[0]) == 0.5
    assert create_syncbn_process_group(0) is None
    with pytest.raises(ValueError, match="feature axis"):
        bn(torch.randn(2, 3, 3, 3))


# ---------------------------------------------------------------------------
# halo_exchange and SpatialBottleneck at world 1
# ---------------------------------------------------------------------------

def _mesh1():
    return Mesh(np.array(jax.devices()[:1]), ("data",))


def test_halo_exchange_world1_matches_jax():
    x = np.arange(2 * 5 * 3 * 4, dtype=np.float32).reshape(2, 5, 3, 4)
    ref = shard_map(lambda a: jax_halo(a, "data", 1), mesh=_mesh1(),
                    in_specs=(P(),), out_specs=P(), check_vma=False)(
        jnp.asarray(x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    got = halo_exchange(xt)
    assert got.shape == (2, 4, 7, 3)
    np.testing.assert_array_equal(got.detach().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(ref))
    got.sum().backward()
    assert torch.equal(xt.grad, torch.ones_like(xt))


def _jax_spatial(filters, x_nhwc):
    blk = JaxSpatial(filters=filters, axis_name="data")
    mesh = _mesh1()
    v = shard_map(lambda a: blk.init(jax.random.PRNGKey(0), a), mesh=mesh,
                  in_specs=(P(),), out_specs=P(), check_vma=False)(x_nhwc)
    v = jax.tree.map(np.asarray, v)

    def loss(params, a):
        y, new = blk.apply({"params": params,
                            "batch_stats": v["batch_stats"]}, a,
                           mutable=["batch_stats"])
        return jnp.sum(y * jnp.sin(y)), (y, new["batch_stats"])

    def run(params, a):
        (_, (y, new)), grads = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(params, a)
        return y, new, grads

    y, new, (gp, gx) = shard_map(run, mesh=mesh, in_specs=(P(), P()),
                                 out_specs=P(), check_vma=False)(
        v["params"], x_nhwc)
    return v, jax.tree.map(np.asarray, (y, new, gp, gx))


@pytest.mark.parametrize("in_features,filters", [(16, 4), (8, 4)])
def test_spatial_bottleneck_world1_matches_jax(in_features, filters):
    rng = np.random.RandomState(6)
    x = rng.randn(2, 6, 5, in_features).astype(np.float32)
    v, (y_ref, stats_ref, gp_ref, gx_ref) = _jax_spatial(filters,
                                                         jnp.asarray(x))
    blk = SpatialBottleneck.params_from_jax(in_features, filters,
                                            variables=v, device="cpu")
    assert blk.needs_proj == (in_features != 4 * filters)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    xt.requires_grad_()
    y = blk(xt)
    (y * torch.sin(y)).sum().backward()
    y_np = y.detach().permute(0, 2, 3, 1).numpy()
    tol = 1e-4 * np.abs(y_ref).max()
    np.testing.assert_allclose(y_np, y_ref, rtol=0, atol=tol)
    gx = xt.grad.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(gx, gx_ref, rtol=0,
                               atol=1e-4 * np.abs(gx_ref).max())
    for scope, leaves in gp_ref.items():
        for leaf, ref in leaves.items():
            name = scope if leaf == "kernel" else f"{scope}.{leaf}"
            g = dict(blk.named_parameters())[name].grad
            if leaf == "kernel":
                g = g.permute(2, 3, 1, 0)
            np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                       atol=1e-4 * np.abs(ref).max() + 1e-7,
                                       err_msg=name)
    for scope, leaves in stats_ref.items():
        np.testing.assert_allclose(
            getattr(blk, scope).running_mean.numpy(), leaves["mean"],
            rtol=0, atol=1e-5 * np.abs(leaves["mean"]).max() + 1e-7)
        np.testing.assert_allclose(
            getattr(blk, scope).running_var.numpy(), leaves["var"],
            rtol=0, atol=1e-5 * np.abs(leaves["var"]).max())


def test_spatial_bottleneck_world1_is_the_port_bottleneck():
    """At world 1 the two blocks compute the same function when they carry
    the same weights (the running statistics follow different
    conventions: flax's in the ResNet block, torch's in SyncBatchNorm)."""
    torch.manual_seed(0)
    sp = SpatialBottleneck(16, 4, device="cpu")
    with torch.no_grad():
        for p in sp.parameters():
            if p.dim() == 4:
                p.normal_(0, 0.3)
    ref = Bottleneck(16, 4, device="cpu")
    with torch.no_grad():
        ref.Conv_0.copy_(sp.conv1)
        ref.Conv_1.copy_(sp.conv2)
        ref.Conv_2.copy_(sp.conv3)
    x = torch.randn(2, 16, 6, 5)
    assert Bottleneck is port_resnet.Bottleneck
    torch.testing.assert_close(sp(x), ref(x), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="stride 1"):
        SpatialBottleneck(16, 4, strides=2, device="cpu")
