"""``halo_exchange``, ``SpatialBottleneck`` and grouped ``SyncBatchNorm``
across ranks: gloo process groups of 2 and 4 spawned on the CPU, against
the JAX package's ``shard_map`` over 2 and 4 host devices and against the
port's own unsharded block.

One spawn per world runs every multi-rank check and saves each rank's
readings with ``torch.save``; the JAX references and the unsharded port
are computed in the parent while the ranks run. The parent joins with a
deadline and kills stragglers, and every process group has a 60 s
timeout, so a hang fails the test instead of stalling the suite.

- world 2 and 4: each rank's haloed rows against
  ``tests/test_contrib_misc.py``'s expectations (own rows, the
  neighbours' edge rows, zeros at the volume's edges), exactly;
- world 2: ``SpatialBottleneck`` (16 -> 4 -> 16, H 8 split 4 + 4,
  parameters from a numpy-seeded flax tree through ``params_from_jax``)
  against JAX's H-sharded ``shard_map`` (outputs and running statistics
  within 1e-4 of the largest value: flax's and torch's fp32 convolutions
  sum in other orders) and against the port's unsharded block (outputs,
  input gradients, parameter gradients summed over the ranks, running
  statistics: within 1e-5 of the largest value — the ranks' partial sums
  are added by gloo in another order);
- world 4: ``SyncBatchNorm`` over groups of two ranks
  (``create_syncbn_process_group(2)``) against JAX's ``axis_index_groups``
  (its ``_grouped_psum``): outputs, input gradients and each rank's
  running statistics within 1e-5 of the largest value.
"""

from __future__ import annotations

import os
import time
import traceback
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLDS = (2, 4)
DEADLINE_S = 90
IN, FILTERS, H, WIDTH, BATCH = 16, 4, 8, 5, 2


def _spatial_vars():
    """A flax variable tree of the JAX SpatialBottleneck(filters=4) over
    16 input features, from numpy seed 0."""
    rng = np.random.RandomState(0)

    def kern(*shape):
        return (rng.randn(*shape) * 0.3).astype(np.float32)

    def norm(c):
        return {"weight": (1 + 0.1 * rng.randn(c)).astype(np.float32),
                "bias": (0.1 * rng.randn(c)).astype(np.float32)}

    out = FILTERS * 4
    params = {"conv1": {"kernel": kern(1, 1, IN, FILTERS)},
              "n1": norm(FILTERS),
              "conv2": {"kernel": kern(3, 3, FILTERS, FILTERS)},
              "n2": norm(FILTERS),
              "conv3": {"kernel": kern(1, 1, FILTERS, out)},
              "n3": norm(out)}
    stats = {n: {"mean": np.zeros(c, np.float32),
                 "var": np.ones(c, np.float32)}
             for n, c in (("n1", FILTERS), ("n2", FILTERS), ("n3", out))}
    return {"params": params, "batch_stats": stats}


def _spatial_x():
    return np.random.RandomState(1).randn(BATCH, H, WIDTH, IN).astype(
        np.float32)                                           # NHWC


def _bn_x():
    rng = np.random.RandomState(2)
    return (rng.randn(8, 3, 3, 8) * 2 + 0.5).astype(np.float32)   # NHWC


def _halo_x(world):
    return np.arange(world * 2 * 3, dtype=np.float32).reshape(
        1, world * 2, 3, 1)                                   # NHWC


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


# ---------------------------------------------------------------------------
# ranks (spawned; no JAX here)
# ---------------------------------------------------------------------------


def _port_spatial(x_nchw):
    """The port's block on ``x_nchw``: output, input gradient, parameter
    gradients and running statistics of loss = sum(y * sin(y))."""
    from apex_tpu_torch.contrib.bottleneck import SpatialBottleneck
    blk = SpatialBottleneck.params_from_jax(IN, FILTERS,
                                            variables=_spatial_vars(),
                                            device="cpu")
    x = x_nchw.clone().requires_grad_()
    y = blk(x)
    (y * torch.sin(y)).sum().backward()
    grads = {n: p.grad.clone() for n, p in blk.named_parameters()}
    stats = {n: b.clone() for n, b in blk.named_buffers()}
    return y.detach(), x.grad, grads, stats


def _checks(world, rank):
    from apex_tpu_torch.contrib.bottleneck import halo_exchange
    from apex_tpu_torch.parallel import (SyncBatchNorm,
                                         create_syncbn_process_group)
    res = {}
    xh = _nchw(_halo_x(world))
    res["halo"] = halo_exchange(xh[:, :, 2 * rank:2 * rank + 2]).numpy()
    if world == 2:
        rows = H // world
        x = _nchw(_spatial_x())[:, :, rows * rank:rows * (rank + 1)]
        y, gx, grads, stats = _port_spatial(x)
        for g in grads.values():
            dist.all_reduce(g)
        res["spatial"] = dict(y=y, gx=gx, grads=grads, stats=stats)
    if world == 4:
        group = create_syncbn_process_group(2)
        bn = SyncBatchNorm(8, group=group, device="cpu")
        x = _nchw(_bn_x())[2 * rank:2 * rank + 2].requires_grad_()
        y = bn(x)
        (y * torch.sin(y)).sum().backward()
        res["bn"] = dict(y=y.detach(), gx=x.grad,
                         mean=bn.running_mean.clone(),
                         var=bn.running_var.clone())
    return res


def _worker(rank, world, rdzv, out_dir):
    torch.set_num_threads(1)
    path = os.path.join(out_dir, f"rank{rank}.pt")
    try:
        dist.init_process_group("gloo", init_method=f"file://{rdzv}",
                                rank=rank, world_size=world,
                                timeout=timedelta(seconds=60))
        res = _checks(world, rank)
        dist.barrier()
        torch.save({"ok": res}, path)
    except BaseException:                     # reported by the parent
        torch.save({"error": traceback.format_exc()}, path)
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# references (parent only)
# ---------------------------------------------------------------------------


def _jax_refs(world):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from apex_tpu._compat import shard_map
    from apex_tpu.contrib.bottleneck import SpatialBottleneck
    from apex_tpu.parallel.sync_batchnorm import (
        SyncBatchNorm, create_syncbn_process_group)

    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    refs = {}
    if world == 2:
        blk = SpatialBottleneck(filters=FILTERS, axis_name="data")

        def run(v, x):
            y, new = blk.apply(v, x, mutable=["batch_stats"])
            return y, new["batch_stats"]

        y, stats = shard_map(run, mesh=mesh, in_specs=(P(), P(None, "data")),
                             out_specs=(P(None, "data"), P()),
                             check_vma=False)(_spatial_vars(),
                                              jnp.asarray(_spatial_x()))
        refs["spatial"] = (np.asarray(y), jax.tree.map(np.asarray, stats))
    if world == 4:
        groups = create_syncbn_process_group(2, world)
        bn = SyncBatchNorm(num_features=8, axis_name="data",
                           axis_index_groups=groups)
        v = {"params": {"weight": np.ones(8, np.float32),
                        "bias": np.zeros(8, np.float32)},
             "batch_stats": {"mean": np.zeros(8, np.float32),
                             "var": np.ones(8, np.float32)}}

        def run(x):
            def loss(a):
                y, new = bn.apply(v, a, mutable=["batch_stats"])
                return jnp.sum(y * jnp.sin(y)), (y, new["batch_stats"])
            (_, (y, st)), gx = jax.value_and_grad(loss, has_aux=True)(x)
            return y, gx, st["mean"][None], st["var"][None]

        out = shard_map(run, mesh=mesh, in_specs=(P("data"),),
                        out_specs=(P("data"),) * 4, check_vma=False)(
            jnp.asarray(_bn_x()))
        refs["bn"] = tuple(np.asarray(a) for a in out)
    return refs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ctx = mp.get_context("spawn")
    procs = {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"bottleneck_world{world}")
        procs[world] = (d, [ctx.Process(target=_worker,
                                        args=(r, world, str(d / "rdzv"),
                                              str(d)))
                            for r in range(world)])
        for p in procs[world][1]:
            p.start()
    try:
        refs = {world: _jax_refs(world) for world in WORLDS}
        refs[2]["unsharded"] = _port_spatial(_nchw(_spatial_x()))
    finally:
        deadline = time.monotonic() + DEADLINE_S
        for _, ps_ in procs.values():
            for p in ps_:
                p.join(max(0.0, deadline - time.monotonic()))
        for _, ps_ in procs.values():
            for p in ps_:
                if p.is_alive():
                    p.kill()
                    p.join()
    out = {}
    for world, (d, ps_) in procs.items():
        errs, ranks = [], []
        for r, p in enumerate(ps_):
            f = d / f"rank{r}.pt"
            got = torch.load(f, weights_only=False) if f.exists() else None
            if got is None or "error" in got:
                errs.append(f"rank {r} (exit {p.exitcode}): "
                            f"{got['error'] if got else 'no result'}")
            else:
                ranks.append(got["ok"])
        assert not errs, "\n".join(errs)
        out[world] = (ranks, refs[world])
    return out


def _close(got, ref, rel, what):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= rel * max(float(np.abs(ref).max()), 1e-30), \
        f"{what}: {err}"


def _from_nchw(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("world", WORLDS)
def test_halo_exchange_rows(runs, world):
    ranks, _ = runs[world]
    xs = _halo_x(world).reshape(world, 2, 3)
    for r, res in enumerate(ranks):
        y = res["halo"].reshape(4, 3)                  # [1, 1, 4, 3]
        np.testing.assert_array_equal(y[1:3], xs[r])               # own
        if r > 0:
            np.testing.assert_array_equal(y[0], xs[r - 1, -1])     # upper
        else:
            assert (y[0] == 0).all()
        if r < world - 1:
            np.testing.assert_array_equal(y[3], xs[r + 1, 0])      # lower
        else:
            assert (y[3] == 0).all()


def test_spatial_bottleneck_world2_matches_jax_and_unsharded(runs):
    ranks, refs = runs[2]
    y_jax, stats_jax = refs["spatial"]
    y_full, gx_full, grads_full, stats_full = refs["unsharded"]
    y = np.concatenate([_from_nchw(r["spatial"]["y"]) for r in ranks],
                       axis=1)
    _close(y, y_jax, 1e-4, "y vs JAX")
    _close(y, _from_nchw(y_full), 1e-5, "y vs unsharded")
    gx = np.concatenate([_from_nchw(r["spatial"]["gx"]) for r in ranks],
                        axis=1)
    _close(gx, _from_nchw(gx_full), 1e-5, "dx vs unsharded")
    for r in ranks:
        for name, g in r["spatial"]["grads"].items():
            _close(g.numpy(), grads_full[name].numpy(), 1e-5, name)
        for name, b in r["spatial"]["stats"].items():
            _close(b.numpy(), stats_full[name].numpy(), 1e-5, name)
            scope, leaf = name.split(".")
            ref = stats_jax[scope]["mean" if leaf == "running_mean"
                                   else "var"]
            _close(b.numpy(), ref, 1e-4, f"{name} vs JAX")


def test_grouped_sync_batchnorm_world4_matches_jax(runs):
    ranks, refs = runs[4]
    y_ref, gx_ref, mean_ref, var_ref = refs["bn"]
    y = np.concatenate([_from_nchw(r["bn"]["y"]) for r in ranks])
    gx = np.concatenate([_from_nchw(r["bn"]["gx"]) for r in ranks])
    _close(y, y_ref, 1e-5, "y")
    _close(gx, gx_ref, 1e-5, "dx")
    for r, res in enumerate(ranks):
        _close(res["bn"]["mean"].numpy(), mean_ref[r], 1e-5, f"mean {r}")
        _close(res["bn"]["var"].numpy(), var_ref[r], 1e-5, f"var {r}")
    # the two groups saw different rows: their statistics differ
    assert not np.allclose(mean_ref[0], mean_ref[2])
