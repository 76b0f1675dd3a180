"""apex_tpu_torch's FusedSGD against the JAX package's over three steps and
two param groups, in fp32.

Parameters and the gradients of each step are made with numpy from a seed
and handed to both sides. Group 0 holds a [7, 5] matrix and a [5] vector
and takes the configuration under test; group 1 holds an [11] vector with
its own learning rate, momentum and dampening. After each step the
parameters, the momentum buffers and the ``initialized`` flag are compared:
fp32 elementwise math on both sides (XLA may contract a multiply and an
add into one FMA), within 1e-6 relative plus 1e-7 absolute.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.optimizers import FusedSGD as JFusedSGD
from apex_tpu_torch.optimizers import FusedSGD

SHAPES = ([(7, 5), (5,)], [(11,)])
GROUP1 = dict(lr=0.05, momentum=0.5, dampening=0.1)
CONFIGS = {
    "momentum": dict(lr=0.1, momentum=0.9, weight_decay=1e-4),
    "nesterov": dict(lr=0.1, momentum=0.9, weight_decay=1e-4,
                     nesterov=True),
    "dampening": dict(lr=0.1, momentum=0.9, dampening=0.3),
    "wd_after_momentum": dict(lr=0.1, momentum=0.9, weight_decay=1e-2,
                              wd_after_momentum=True),
    "no_momentum": dict(lr=0.1, weight_decay=1e-3),
}


def _arrays(seed):
    rng = np.random.RandomState(seed)
    return [[rng.randn(*s).astype(np.float32) for s in g] for g in SHAPES]


def _flat(arrays):
    return np.concatenate([np.asarray(a, np.float32).reshape(-1)
                           for a in arrays])


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                               err_msg=what)


def _make(cls, params, cfg):
    kw = dict(cfg)
    wd_after = kw.pop("wd_after_momentum", False)
    opt = cls(params[0], wd_after_momentum=wd_after, **kw)
    opt.add_param_group({"params": params[1], **GROUP1})
    return opt


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_three_steps_two_groups_match_jax(config):
    cfg = CONFIGS[config]
    init = _arrays(0)
    jparams = [[jnp.asarray(a) for a in g] for g in init]
    tparams = [[torch.from_numpy(a.copy()) for a in g] for g in init]
    jopt, topt = _make(JFusedSGD, jparams, cfg), _make(FusedSGD, tparams, cfg)
    jstate, tstate = jopt.init(), topt.init()
    for step in range(3):
        grads = _arrays(10 + step)
        jparams, jstate = jopt.apply(
            jstate, jparams, [[jnp.asarray(a) for a in g] for g in grads])
        tparams, tstate = topt.apply(
            tstate, tparams, [[torch.from_numpy(a) for a in g] for g in grads])
        for gi in range(2):
            _close(_flat([p.numpy() for p in tparams[gi]]),
                   _flat(jparams[gi]), f"{config} step {step} group {gi}")
            jslots, tslots = jstate.groups[gi].slots, tstate.groups[gi].slots
            assert set(tslots) == set(jslots)
            if "momentum_buffer" in jslots:
                _close(tslots["momentum_buffer"].numpy(),
                       _flat(jax.tree.leaves(jslots["momentum_buffer"])),
                       f"{config} step {step} group {gi} momentum")
                assert bool(tslots["initialized"]) is \
                    bool(jslots["initialized"]) is True
            assert int(tstate.groups[gi].step) == \
                int(jstate.groups[gi].step) == step + 1


def test_first_touch_sets_the_buffer_to_the_gradient():
    """torch SGD's first step: ``buf = g``, no dampening."""
    p = torch.zeros(4)
    opt = FusedSGD([p], lr=1.0, momentum=0.9, dampening=0.5)
    state = opt.init()
    assert not bool(state.groups[0].slots["initialized"])
    g = torch.arange(4.0)
    _, state = opt.apply(state, [p], [g])
    assert torch.equal(state.groups[0].slots["momentum_buffer"], g)
    assert torch.equal(p, -g)


@pytest.mark.parametrize("kw", [dict(momentum=0.0, nesterov=True),
                                dict(momentum=0.9, dampening=0.1,
                                     nesterov=True)])
def test_nesterov_needs_momentum_and_no_dampening(kw):
    with pytest.raises(ValueError, match="Nesterov"):
        FusedSGD([torch.zeros(2)], lr=0.1, **kw)
    with pytest.raises(ValueError, match="Nesterov"):
        JFusedSGD([jnp.zeros(2)], lr=0.1, **kw)


@pytest.mark.parametrize("first", [True, False])
def test_skipped_step_is_bitwise(first):
    """A skipped step (amp's overflow skip) leaves the parameters, the
    momentum buffers, the ``initialized`` flag and the step counter
    bitwise as they were, on the first step as on a later one."""
    init = _arrays(1)
    params = [[torch.from_numpy(a.copy()) for a in g] for g in init]
    opt = _make(FusedSGD, params, CONFIGS["nesterov"])
    state = opt.init()
    if not first:
        _, state = opt.apply(state, params, [[torch.from_numpy(a) for a in g]
                                             for g in _arrays(2)])
    before = [p.clone() for g in params for p in g]
    slots = [{k: v.clone() for k, v in g.slots.items()}
             for g in state.groups]
    steps = [int(g.step) for g in state.groups]
    bad = [[torch.full_like(p, float("nan")) for p in g] for g in params]
    _, new = opt.apply(state, params, bad, skip=torch.tensor(True))
    for p, b in zip([p for g in params for p in g], before):
        assert torch.equal(p, b)
    for g, s, n in zip(new.groups, slots, steps):
        assert int(g.step) == n
        for k, v in s.items():
            assert g.slots[k].dtype == v.dtype and torch.equal(g.slots[k], v)
    assert bool(new.groups[0].slots["initialized"]) is (not first)
