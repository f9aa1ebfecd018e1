"""The port's RL tier (``deeplearning4j_tpu_torch/rl``) against the JAX
package's, on the CPU.

CartPole, the replay buffer and the epsilon-greedy policy are copies of the
JAX package's host code: trajectories, samples and actions are equal
exactly. DQN: the same Q-network (the JAX params loaded with
``load_jax_params``) computes the same TD targets, and one ``train_step``
and a short training run give the same params, to ``TOL_RL`` (absolute:
float32 products in another summation order, ~6e-8 read). A3C: the JAX
agent's params (drawn with ``jax.random``) loaded into the port, one update
on the same batch and a short run agree to ``TOL_RL`` (the JAX agent's
heads are float64 under x64 where the port's are float32: ~2e-7 read)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu import rl as jrl

from deeplearning4j_tpu_torch import rl as trl
from deeplearning4j_tpu_torch.model import load_jax_params

TOL_RL = 1e-5


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_cartpole_trajectories_match_jax(seed):
    j, t = jrl.CartPole(max_steps=60, seed=seed), trl.CartPole(max_steps=60, seed=seed)
    acts = np.random.RandomState(seed).randint(0, 2, 400)
    for episode in range(3):
        assert np.array_equal(t.reset(), j.reset())
        for a in acts[episode * 100:]:
            rj, rt = j.step(int(a)), t.step(int(a))
            assert np.array_equal(rt.observation, rj.observation)
            assert (rt.reward, rt.done) == (rj.reward, rj.done)
            if rj.done:
                break
        assert t.is_done() and j.is_done()


def test_replay_and_policies_match_jax():
    jr, tr = jrl.ExpReplay(7, 4, seed=2), trl.ExpReplay(7, 4, seed=2)
    rs = np.random.RandomState(0)
    for i in range(12):
        o, n = rs.randn(4).astype(np.float32), rs.randn(4).astype(np.float32)
        jr.store(jrl.Transition(o, i % 2, float(i), n, i % 5 == 0))
        tr.store(trl.Transition(o, i % 2, float(i), n, i % 5 == 0))
    for _ in range(3):
        for a, b in zip(jr.sample(), tr.sample()):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    q = lambda x: np.array([[0.2, 0.7]])  # noqa: E731
    jp = jrl.EpsGreedyPolicy(q, 2, eps_start=1.0, eps_min=0.1, decay_steps=20, seed=4)
    tp = trl.EpsGreedyPolicy(q, 2, eps_start=1.0, eps_min=0.1, decay_steps=20, seed=4)
    obs = np.zeros(4, np.float32)
    assert [tp.next_action(obs) for _ in range(30)] == [jp.next_action(obs) for _ in range(30)]
    assert tp.epsilon == jp.epsilon


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _max_gap(jparams, tparams):
    return max(float(np.abs(np.asarray(jparams[l][k]) - tparams[l][k].detach().numpy()).max())
               for l in jparams for k in jparams[l])


def _dqn_pair(double, **over):
    conf = dict(seed=3, hidden=(8, 8), batch_size=8, max_step=60, update_start=10,
                target_dqn_update_freq=20, exp_replay_size=100, double_dqn=double)
    conf.update(over)
    j = jrl.QLearningDiscreteDense(jrl.CartPole(seed=2), jrl.QLearningConfiguration(**conf))
    t = trl.QLearningDiscreteDense(trl.CartPole(seed=2), trl.QLearningConfiguration(**conf),
                                   device="cpu")
    load_jax_params(t.network, _np_tree(j.network.params))
    t.target_params = {l: {k: p.detach().clone() for k, p in lp.items()}
                       for l, lp in t.network.params.items()}
    return j, t


@pytest.mark.parametrize("double", [True, False], ids=["double-dqn", "dqn"])
def test_dqn_td_targets_and_train_step_match_jax(double):
    j, t = _dqn_pair(double)
    rs = np.random.RandomState(5)
    for i in range(20):
        o, n = rs.randn(4).astype(np.float32), rs.randn(4).astype(np.float32)
        for agent, T in ((j, jrl.Transition), (t, trl.Transition)):
            agent.replay.store(T(o, i % 2, 1.0, n, i % 7 == 0))
    # a target network that differs from the live one
    j.target_params = jax.tree_util.tree_map(lambda a: a * 0.5, j.network.params)
    load_jax_params(t.network, _np_tree(j.target_params))
    t.target_params = {l: {k: p.detach().clone() for k, p in lp.items()}
                       for l, lp in t.network.params.items()}
    load_jax_params(t.network, _np_tree(j.network.params))
    batch = j.replay.sample()
    t.replay.sample()  # keep the two buffers' draws in step
    np.testing.assert_allclose(t._td_targets(*batch), j._td_targets(*batch), rtol=0,
                               atol=TOL_RL)
    j.train_step()
    t.train_step()
    assert _max_gap(j.network.params, t.network.params) < TOL_RL
    # the target network is a copy: the live step did not move it
    assert _max_gap(j.target_params, t.target_params) < TOL_RL


def test_dqn_training_matches_jax():
    j, t = _dqn_pair(True)
    assert t.train() == j.train()
    assert _max_gap(j.network.params, t.network.params) < TOL_RL
    obs = np.random.RandomState(1).randn(4).astype(np.float32)
    assert t.get_policy().next_action(obs) == j.get_policy().next_action(obs)


def _a3c_pair(**conf):
    j = jrl.A3CDiscreteDense(lambda: jrl.CartPole(seed=1), jrl.A3CConfiguration(**conf))
    t = trl.A3CDiscreteDense(lambda: trl.CartPole(seed=1), trl.A3CConfiguration(**conf),
                             device="cpu")
    load_jax_params(t, {k: np.asarray(v) for k, v in j.params.items()})
    return j, t


def _a3c_gap(j, t):
    return max(float(np.abs(np.asarray(j.params[k]) - t.params[k].detach().numpy()).max())
               for k in j.params)


def test_a3c_update_matches_jax():
    j, t = _a3c_pair(num_threads=2, n_step=4, hidden=(8, 8))
    assert set(t.params) == set(j.params)
    rs = np.random.RandomState(0)
    obs = rs.randn(8, 4).astype(np.float32)
    act = rs.randint(0, 2, 8).astype(np.int32)
    ret = rs.randn(8).astype(np.float32)
    for _ in range(2):  # the second step reads Adam's carried moments
        j.params, j.opt_state, jl = j._update_jit(j.params, j.opt_state, jnp.asarray(obs),
                                                  jnp.asarray(act), jnp.asarray(ret))
        tl = t._update(t._put(obs), t._put(act), t._put(ret))
        assert float(tl) == pytest.approx(float(jl), rel=TOL_RL)
        assert _a3c_gap(j, t) < TOL_RL


def test_a3c_training_matches_jax():
    j, t = _a3c_pair(num_threads=2, n_step=4, max_step=160, max_epoch_step=50, hidden=(8, 8))
    j.train()
    t.train()
    assert t.episode_rewards == j.episode_rewards and len(t.episode_rewards) >= 3
    assert _a3c_gap(j, t) < TOL_RL
    obs = np.random.RandomState(2).randn(4).astype(np.float32)
    assert t.get_policy().next_action(obs) == j.get_policy().next_action(obs)
