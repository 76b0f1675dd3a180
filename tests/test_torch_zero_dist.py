"""The port's ZeRO across ranks: gloo process groups of 2 and 4 spawned on
the CPU, against the JAX package's ``shard_map`` over 2 and 4 host devices
(as ``tests/test_zero.py`` runs it).

One spawn per world runs every multi-rank check and saves rank 0's
readings with ``torch.save``; the JAX references are computed in the
parent while the ranks run. The parent joins with a deadline and kills
stragglers, and every process group has a 60 s timeout, so a hang fails
the test instead of stalling the suite.

The tree is ``tests/test_zero.py``'s small MLP (``w1`` [64, 33], ``b1``
[33], ``w2`` [33, 70]: ``w2``'s 2,310 elements pad at worlds 4 and 8),
each rank training on its own two rows of a numpy-seeded batch.

Tolerances:

- tiers 1/2 and 3, Adam and LAMB, three steps against JAX: params,
  masters and moments within 5e-5 of the largest value of each (fp32
  reassociation: gloo and XLA sum the ranks' terms and the matmuls'
  products in other orders, and XLA contracts multiply-adds; Adam's
  normalization turns a tiny gradient's rounding into an lr-sized move;
  read at most 1.9e-5);
- ``zero_gather``'s backward against the reduce-scatter of the summed full
  gradient: within 1e-6 of the largest (the same rank terms, summed by
  two collectives); the bf16 cotangents are reduce-scattered in bf16 and
  match JAX's bf16 ``psum_scatter`` within 2 % of the largest (the bf16
  products round at other points in the two frameworks; read 0.9 %);
- the quantized gather, raw and scaled, against JAX: bitwise;
- the overflow skip, synchronized when one rank's shard alone holds the
  inf: bitwise on every rank;
- elastic dp=4 -> gather -> dp=2 -> dp=4 against an uninterrupted dp=4
  run: bitwise, params and (step, master, m, v). JAX checks dp=8 -> 4 ->
  8; four ranks is what the test budget affords here, and the dp=2 leg
  runs on a subgroup of the same four processes.
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

LR = 1e-2
ADAM = dict(lr=LR, weight_decay=0.05)
LAMB = dict(lr=LR, weight_decay=0.01, max_grad_norm=1.0, eps=1e-6)
WORLDS = (2, 4)
DEADLINE_S = 90
TOL = 5e-5          # of the largest value; module docstring


def _params_np():
    rng = np.random.RandomState(0)          # tests/test_zero.py's draws
    w1 = (rng.randn(64, 33) * 0.2).astype(np.float32)
    b1 = (rng.randn(33) * 0.1).astype(np.float32)
    w2 = (rng.randn(33, 70) * 0.2).astype(np.float32)
    # sorted names: the JAX flat buffers' leaf order
    return {"b1": b1, "w1": w1, "w2": w2}


def _batch_np(world, rows_per=2):
    rng = np.random.RandomState(1)
    return ((rng.randn(rows_per * world, 64)).astype(np.float32),
            (rng.randn(rows_per * world, 70)).astype(np.float32))


def _quant_np(world, per=96):
    rng = np.random.RandomState(3)
    x = (rng.randn(world * per) * 0.5).astype(np.float32)
    x[::17] *= 3e5           # past e5m2's 57344 (raw saturates or infs)
    x[5::23] *= 1e-9         # deep in its subnormals
    return x


# ---------------------------------------------------------------------------
# ranks (spawned; no JAX here)
# ---------------------------------------------------------------------------


def _loss(p, x, y):
    return torch.mean((torch.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] - y) ** 2)


def _local(world, rank):
    x, y = _batch_np(world)
    return (torch.from_numpy(x[2 * rank:2 * rank + 2]),
            torch.from_numpy(y[2 * rank:2 * rank + 2]))


def _tree():
    return {k: torch.from_numpy(v.copy()) for k, v in _params_np().items()}


def _tier12(kind, world, rank):
    from apex_tpu_torch.zero import ZeroOptimizer
    params = {k: v.requires_grad_() for k, v in _tree().items()}
    opt = ZeroOptimizer(kind=kind, shard_params=False,
                        **(ADAM if kind == "adam" else LAMB))
    st = opt.init(params)
    x, y = _local(world, rank)
    for _ in range(3):
        grads = torch.autograd.grad(_loss(params, x, y),
                                    list(params.values()))
        _, st = opt.apply(st, params, dict(zip(params, grads)))
    full = opt.gather_state(st)
    return dict(params={k: v.detach().clone() for k, v in params.items()},
                step=int(full.step), master=full.master_shard,
                m=full.m_shard, v=full.v_shard)


def _tier3(kind, world, rank):
    from apex_tpu_torch import zero
    tree = _tree()
    spec = zero.build_spec(tree, min_shard_size=64)
    shards = zero.zero_shard(tree, spec)
    opt = zero.ZeroOptimizer(kind=kind, shard_params=True,
                             **(ADAM if kind == "adam" else LAMB))
    st = opt.init(shards, spec)
    x, y = _local(world, rank)
    for _ in range(3):
        leaves = {k: v.detach().requires_grad_() for k, v in shards.items()}
        loss = _loss(zero.zero_gather(leaves, spec), x, y)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        shards, st = opt.apply(st, shards, dict(zip(leaves, grads)))
    full = zero.gather_zero3_state(st, spec)
    return dict(params=zero.gather_zero3_params(shards, spec),
                step=int(full.step), master=full.master, m=full.m,
                v=full.v, sharded=spec.sharded)


def _gather_backward(world, rank):
    """zero_gather's backward vs slicing the summed full gradient; and the
    bf16 cotangents' shards (reduce-scattered in bf16)."""
    from apex_tpu_torch import zero
    from apex_tpu_torch.zero import core
    tree = _tree()
    spec = zero.build_spec(tree, min_shard_size=64)
    x, y = _local(world, rank)
    leaves = {k: v.requires_grad_() for k, v in zero.zero_shard(
        tree, spec).items()}
    g_sh = torch.autograd.grad(_loss(zero.zero_gather(leaves, spec), x, y),
                               list(leaves.values()))
    full = {k: v.clone().requires_grad_() for k, v in tree.items()}
    g_full = torch.autograd.grad(_loss(full, x, y), list(full.values()))
    summed = {}
    for k, g in zip(full, g_full):
        dist.all_reduce(g, op=dist.ReduceOp.SUM)
        summed[k] = g
    ref = core.shard_tree(summed, spec)
    err = max(float((a - ref[k]).abs().max() / ref[k].abs().max())
              for a, k in zip(g_sh, leaves))
    bf = {k: v.detach().to(torch.bfloat16).requires_grad_()
          for k, v in zero.zero_shard(tree, spec).items()}
    fb = zero.zero_gather(bf, spec)
    out = (torch.tanh(x.bfloat16() @ fb["w1"] + fb["b1"]) @ fb["w2"])
    bg = torch.autograd.grad(out.float().sum(), list(bf.values()))
    # every rank's bf16 shards, gathered for the parent
    shards = {k: zero.comm.all_gather_flat(g.reshape(-1)) if spec.sharded[i]
              else g for i, (k, g) in enumerate(zip(bf, bg))}
    return dict(rel_err=err, bf16_dtypes=sorted({str(g.dtype) for g in bg}),
                bf16_grads={k: v.float() for k, v in shards.items()})


def _quantized(world, rank):
    from apex_tpu_torch.zero import comm
    x = torch.from_numpy(_quant_np(world))
    per = x.numel() // world
    shard = x[rank * per:(rank + 1) * per].clone()
    return {mode: comm.quantized_all_gather(shard, out_dtype=torch.float32,
                                            scaled=mode == "scaled")
            for mode in ("raw", "scaled")}


class _MLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        for k, v in _tree().items():
            setattr(self, k, torch.nn.Parameter(v))

    def forward(self, x):
        return torch.tanh(x @ self.w1 + self.b1) @ self.w2


def _overflow(world, rank):
    """O2 ZeRO-3: a step whose only inf sits in the last element of w2,
    which lives in the last rank's shard alone; every rank must skip."""
    from apex_tpu_torch import amp, zero
    model = _MLP()
    zm, opt = amp.initialize(model, zero.ZeroOptimizer(**ADAM),
                             opt_level="O2", loss_scale="dynamic",
                             verbosity=0, zero=dict(min_shard_size=64))
    st = opt.init(zm.shard(), zm.spec)
    shards = zm.cast_params(zm.shard())
    x, y = _local(world, rank)

    def loss_fn(m, x, y):
        return torch.mean((m(x.bfloat16()).float() - y) ** 2)

    def poisoned(m, x, y):
        extra = m.w2.reshape(-1)[-1].float() * 1e38 if rank == 0 else 0.0
        return loss_fn(m, x, y) + extra

    step = zero.make_train_step(loss_fn, optimizer=opt)
    ss = opt._scaler.state
    shards, st, ss, _ = step(shards, st, ss, x, y)
    before = ([v.clone() for v in shards.values()], st.master.flat.clone(),
              st.m.flat.clone(), st.v.flat.clone(), int(st.step))
    # which ranks' own shards hold the inf, before the flag is summed
    leaves = {k: v.detach().requires_grad_() for k, v in shards.items()}
    loss = zm.call(zm.materialize(leaves), poisoned, x, y)
    grads = torch.autograd.grad(loss * ss.loss_scale, list(leaves.values()))
    local = torch.tensor([int(not all(bool(torch.isfinite(g).all())
                                      for g in grads))])
    seen = zero.comm.all_gather_flat(local)
    bad = zero.make_train_step(poisoned, optimizer=opt)
    shards2, st2, ss2, _ = bad(shards, st, ss, x, y)
    same = (all(torch.equal(a, b) for a, b in zip(shards2.values(),
                                                   before[0]))
            and torch.equal(st2.master.flat, before[1])
            and torch.equal(st2.m.flat, before[2])
            and torch.equal(st2.v.flat, before[3])
            and int(st2.step) == before[4]
            and float(ss2.loss_scale) == float(ss.loss_scale) / 2)
    ok = torch.tensor([int(same)])
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    return dict(inf_seen_by_rank=seen.tolist(), all_skipped_bitwise=int(ok),
                step=int(st2.step))


def _elastic_run(group, params_full, full_state, seeds):
    from apex_tpu_torch import zero
    spec = zero.build_spec(params_full, group=group, min_shard_size=8)
    opt = zero.ZeroOptimizer(lr=LR, weight_decay=0.05, shard_params=True,
                             gradient_average=False, group=group)
    shards = zero.shard_zero3_params(params_full, spec)
    st = (opt.init(shards, spec) if full_state is None
          else zero.shard_zero3_state(full_state, spec))
    for s in seeds:
        rng = np.random.RandomState(s)
        g_full = {k: torch.from_numpy((rng.randn(*v.shape) * 0.01).astype(
            np.float32)) for k, v in params_full.items()}
        g = zero.shard_zero3_params(g_full, spec)
        shards, st = opt.apply(st, shards, g, spec=spec)
    return (zero.gather_zero3_params(shards, spec),
            zero.gather_zero3_state(st, spec))


def _broadcast_tree(tree, src=0):
    out = {}
    for k, v in tree.items():
        v = v.clone().contiguous()
        dist.broadcast(v, src)
        out[k] = v
    return out


def _broadcast_state(state):
    from apex_tpu_torch.zero import Zero3State
    step = state.step.clone()
    dist.broadcast(step, 0)
    return Zero3State(step, *(_broadcast_tree(t) for t in state[1:]))


def _elastic(world, rank):
    """dp=4 -> gather -> dp=2 (ranks 0-1) -> gather -> dp=4, against an
    uninterrupted dp=4 run; bitwise."""
    two = dist.new_group([0, 1])
    p4, s4 = _elastic_run(None, _tree(), None, [10])
    p_ref, s_ref = _elastic_run(None, p4, s4, [12, 13])
    if rank < 2:
        p2, s2 = _elastic_run(two, p4, s4, [12])
    else:
        p2 = {k: torch.empty_like(v) for k, v in p4.items()}
        s2 = type(s4)(torch.zeros_like(s4.step),
                      *({k: torch.empty_like(v) for k, v in t.items()}
                        for t in s4[1:]))
    p2, s2 = _broadcast_tree(p2), _broadcast_state(s2)
    p_back, s_back = _elastic_run(None, p2, s2, [13])
    same = (int(s_back.step) == int(s_ref.step) == 3
            and all(torch.equal(p_back[k], p_ref[k]) for k in p_ref)
            and all(torch.equal(a[k], b[k]) for a, b in
                    zip(s_back[1:], s_ref[1:]) for k in a))
    ok = torch.tensor([int(same)])
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    return dict(bitwise=int(ok), step=int(s_back.step))


def _checks(world, rank):
    out = {f"tier12_{k}": _tier12(k, world, rank) for k in ("adam", "lamb")}
    out.update({f"tier3_{k}": _tier3(k, world, rank)
                for k in ("adam", "lamb")})
    out["gather_backward"] = _gather_backward(world, rank)
    out["quantized"] = _quantized(world, rank)
    out["overflow"] = _overflow(world, rank)
    if world == 4:
        out["elastic"] = _elastic(world, rank)
    return out


def _worker(rank, world, rdzv, out_dir):
    torch.set_num_threads(1)
    path = os.path.join(out_dir, f"rank{rank}.pt")
    try:
        dist.init_process_group("gloo", init_method=f"file://{rdzv}",
                                rank=rank, world_size=world,
                                timeout=timedelta(seconds=60))
        res = _checks(world, rank)
        dist.barrier()
        torch.save({"ok": res} if rank == 0 else {"ok": True}, path)
    except BaseException:                     # reported by the parent
        torch.save({"error": traceback.format_exc()}, path)
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# JAX references (parent only)
# ---------------------------------------------------------------------------


def _jax_refs(world):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from apex_tpu import zero as jzero
    from apex_tpu._compat import shard_map
    from apex_tpu.zero import comm as jcomm
    from apex_tpu.zero.optimizer import ZeroOptimizer as JZeroOptimizer

    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    params = {k: jnp.asarray(v) for k, v in _params_np().items()}
    x, y = (jnp.asarray(a) for a in _batch_np(world))

    def loss(p, x, y):
        return jnp.mean((jnp.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] - y) ** 2)

    refs = {}
    for kind in ("adam", "lamb"):
        hyper = ADAM if kind == "adam" else LAMB
        opt = JZeroOptimizer(kind=kind, shard_params=False, **hyper)

        def run12(p, x, y, opt=opt):
            st = opt.init(p)
            for _ in range(3):
                p, st = opt.apply(st, p, jax.grad(loss)(p, x, y))
            return p, opt.gather_state(st)

        fn = shard_map(run12, mesh=mesh,
                       in_specs=(P(), P("data"), P("data")),
                       out_specs=(P(), P()), check_vma=False)
        p, st = jax.jit(fn)(params, x, y)
        refs[f"tier12_{kind}"] = dict(
            params=jax.device_get(p), step=int(st.step),
            master=np.asarray(st.master_shard), m=np.asarray(st.m_shard),
            v=np.asarray(st.v_shard))

        zm = jzero.ZeroShardedModel(None, min_shard_size=64)
        opt3 = JZeroOptimizer(kind=kind, shard_params=True, **hyper)

        def run3(p, x, y, zm=zm, opt3=opt3):
            shards = zm.shard(p)
            st = opt3.init(shards, zm.spec)
            for _ in range(3):
                g = jax.grad(lambda s: loss(jzero.zero_gather(s, zm.spec),
                                            x, y))(shards)
                shards, st = opt3.apply(st, shards, g, spec=zm.spec)
            return (jzero.gather_zero3_params(shards, zm.spec),
                    jzero.gather_zero3_state(st, zm.spec))

        fn = shard_map(run3, mesh=mesh,
                       in_specs=(P(), P("data"), P("data")),
                       out_specs=(P(), P()), check_vma=False)
        p, st = jax.jit(fn)(params, x, y)
        st = jax.device_get(st)
        refs[f"tier3_{kind}"] = dict(params=jax.device_get(p),
                                     step=int(st.step), master=st.master,
                                     m=st.m, v=st.v)

    # bf16 cotangents reduce-scattered in bf16 (psum_scatter, tiled)
    zm = jzero.ZeroShardedModel(None, min_shard_size=64)

    def runbf(p, x):
        sh = jax.tree.map(lambda a: a.astype(jnp.bfloat16), zm.shard(p))

        def f(s):
            fb = jzero.zero_gather(s, zm.spec)
            out = jnp.tanh(x.astype(jnp.bfloat16) @ fb["w1"] + fb["b1"]) \
                @ fb["w2"]
            return jnp.sum(out.astype(jnp.float32))
        return jax.grad(f)(sh)

    dec = jzero.match_zero_rules(None, params, min_shard_size=64)
    outs = jax.tree.map(lambda d: P("data") if d else P(), dec)
    g = jax.jit(shard_map(runbf, mesh=mesh, in_specs=(P(), P("data")),
                          out_specs=outs, check_vma=False))(params, x)
    refs["bf16_grads"] = {k: np.asarray(v.astype(jnp.float32))
                          for k, v in g.items()}

    q = jnp.asarray(_quant_np(world))
    refs["quantized"] = {}
    for mode in ("raw", "scaled"):
        f = shard_map(lambda s, mode=mode: jcomm.quantized_all_gather(
            s, "data", out_dtype=jnp.float32, scaled=mode == "scaled"),
            mesh=mesh, in_specs=(P("data"),), out_specs=P(),
            check_vma=False)
        refs["quantized"][mode] = np.asarray(jax.jit(f)(q))
    return refs


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ctx = mp.get_context("spawn")
    procs = {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"zero_world{world}")
        procs[world] = (d, [ctx.Process(target=_worker,
                                        args=(r, world, str(d / "rdzv"),
                                              str(d)))
                            for r in range(world)])
        for p in procs[world][1]:
            p.start()
    try:
        refs = {world: _jax_refs(world) for world in WORLDS}
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
        errs = []
        for r, p in enumerate(ps_):
            f = d / f"rank{r}.pt"
            got = torch.load(f, weights_only=False) if f.exists() else None
            if got is None or "error" in got:
                errs.append(f"rank {r} (exit {p.exitcode}): "
                            f"{got['error'] if got else 'no result'}")
        assert not errs, "\n".join(errs)
        out[world] = (torch.load(d / "rank0.pt", weights_only=False)["ok"],
                      refs[world])
    return out


def _close(got, ref, rel, what):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= rel * max(float(np.abs(ref).max()), 1e-30), \
        f"{what}: {err}"


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", ["adam", "lamb"])
def test_tier12_matches_jax(runs, world, kind):
    got, ref = runs[world][0][f"tier12_{kind}"], runs[world][1][
        f"tier12_{kind}"]
    assert got["step"] == ref["step"] == 3
    for k in ("master", "m", "v"):
        _close(got[k].numpy(), ref[k], TOL, k)
    for k, v in got["params"].items():
        _close(v.numpy(), ref["params"][k], TOL, k)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", ["adam", "lamb"])
def test_tier3_matches_jax(runs, world, kind):
    got, ref = runs[world][0][f"tier3_{kind}"], runs[world][1][
        f"tier3_{kind}"]
    assert got["step"] == ref["step"] == 3
    assert got["sharded"] == (False, True, True)    # b1 under the threshold
    for k, v in got["params"].items():
        _close(v.numpy(), ref["params"][k], TOL, k)
    for slot in ("master", "m", "v"):
        for k, v in got[slot].items():
            _close(v.numpy(), ref[slot][k], TOL, f"{slot} {k}")


@pytest.mark.parametrize("world", WORLDS)
def test_zero_gather_backward_is_a_reduce_scatter(runs, world):
    got, ref = runs[world][0]["gather_backward"], runs[world][1]
    assert got["rel_err"] <= 1e-6
    assert got["bf16_dtypes"] == ["torch.bfloat16"]
    for k, v in got["bf16_grads"].items():
        _close(v.numpy(), ref["bf16_grads"][k], 2e-2, f"bf16 {k}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode", ["raw", "scaled"])
def test_quantized_all_gather_is_bitwise_jax(runs, world, mode):
    got = runs[world][0]["quantized"][mode].numpy()
    ref = runs[world][1]["quantized"][mode]
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    if mode == "scaled":
        assert np.isfinite(got).all()


@pytest.mark.parametrize("world", WORLDS)
def test_overflow_skip_is_synchronized_across_ranks(runs, world):
    got = runs[world][0]["overflow"]
    # only the last rank's own shards held the inf
    assert got["inf_seen_by_rank"] == [0] * (world - 1) + [1]
    assert got["all_skipped_bitwise"] == 1 and got["step"] == 1


def test_elastic_dp4_dp2_dp4_is_bitwise(runs):
    got = runs[4][0]["elastic"]
    assert got == {"bitwise": 1, "step": 3}
