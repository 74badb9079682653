"""The port's Ranger (`make_ranger`: RAdam and Lookahead) against the JAX
package's `make_ranger` (optax) on the CPU.

A small tree of three tensors takes 14 steps of seeded gradients, the same
for both: past the rectification threshold (ρ ≥ 5 from step 6) and through
two syncs of the slow weights (steps 6 and 12), with and without weight
decay, and with another sync period and slow step size. The fast weights
after every step and the slow weights at the end are held at rtol 1e-5,
atol 1e-7. The step's scalars are float32 as optax's: in float64 ρ at
step 6 is 5.994, in float32 5.975, and r moves by a percent with it. optax's
update is jitted, as in a train step: evaluated eagerly, JAX takes β2^t by
repeated squaring, an ulp away at some t, which moves ρ and r again.
"""

import numpy as np
import pytest
import torch

from deformablelka_tpu_torch.training.train_step import Ranger, make_ranger

torch.set_num_threads(1)
SHAPES = {"a": (4, 3), "b": (5,), "c": (2, 2, 3)}
STEPS = 14


def _tree(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*s) * scale).astype(np.float32) for k, s in SHAPES.items()}


@pytest.mark.parametrize("wd,sync,alpha", [(0.0, 6, 0.5), (1e-2, 6, 0.5), (1e-2, 4, 0.8)])
def test_ranger_matches_optax(wd, sync, alpha):
    import jax
    import jax.numpy as jnp
    import optax

    from deformablelka_tpu.training.train_step import make_ranger as jax_make_ranger

    lr = 3e-2
    init = _tree(0)
    tx = jax_make_ranger(lr, weight_decay=wd, sync_period=sync, slow_step_size=alpha)
    jp = optax.LookaheadParams.init_synced({k: jnp.asarray(v) for k, v in init.items()})
    state = tx.init(jp)
    update = jax.jit(tx.update)   # as in a jitted train step
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = make_ranger(params.values(), lr, weight_decay=wd, sync_period=sync,
                      slow_step_size=alpha)
    for t in range(STEPS):
        g = _tree(100 + t, scale=0.5)
        upd, state = update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp.fast[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"step {t + 1} {k}")
    for k, p in params.items():
        np.testing.assert_allclose(opt.state[p]["slow"].numpy(), np.asarray(jp.slow[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert opt.count == STEPS and opt.steps_since_sync == STEPS % sync


def test_ranger_rectifies_from_step_six():
    """Below the threshold the update is the bias-corrected momentum alone:
    one step of gradient g moves p by −lr·g (to float32's rounding of m̂)."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = Ranger([p], lr=0.1)
    p.grad = torch.tensor([1.0, -2.0, 0.5])
    opt.step()
    torch.testing.assert_close(p.detach(), torch.tensor([0.9, 1.2, 0.95]), rtol=0, atol=2.5e-7)
    rectified = []
    for _ in range(7):
        opt.count += 1
        rectified.append(opt._scalars()[2] is not None)
        opt.count -= 1
        opt.step()
    assert rectified == [False] * 4 + [True] * 3


def test_ranger_skips_frozen_parameters():
    a = torch.nn.Parameter(torch.ones(2))
    b = torch.nn.Parameter(torch.ones(2), requires_grad=False)
    opt = make_ranger([a, b], 1e-2)
    assert [p for g in opt.param_groups for p in g["params"]] == [a]
    with pytest.raises(ValueError):
        Ranger([a], 1e-2, sync_period=0)
