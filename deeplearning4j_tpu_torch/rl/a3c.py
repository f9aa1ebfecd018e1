"""A3C — advantage actor-critic (port of ``deeplearning4j_tpu/rl/a3c.py``;
reference: rl4j A3CDiscrete/A3CDiscreteDense + AsyncNStepQLearning's worker
machinery, SURVEY.md §2.2 "RL4J").

Design note (the JAX package's stance, kept): the reference's "async" is
N CPU worker threads with local nets racing updates into a global param
store — a scheme built for many weak cores. On one strong accelerator the
equivalent work batches: N environment "workers" step in lockstep, their
observations stack into one policy/value forward, and the n-step
advantage-actor-critic update is ONE step (policy gradient + entropy bonus
+ value MSE) under the port's Adam transformation with optax's defaults.
Objective and hyperparameter vocabulary follow the reference; the
execution schedule is synchronous (A2C) by design. Actions are sampled on
the host from the card's probabilities with the agent's ``RandomState``.

The parameters are drawn from a ``torch.Generator`` seeded with
``conf.seed``; the JAX package's (drawn with ``jax.random``) load with
:func:`~deeplearning4j_tpu_torch.model.load_jax_params`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from ..core.dtypes import default_device
from ..train.updaters import Adam, apply_updates
from .mdp import MDP


@dataclasses.dataclass
class A3CConfiguration:
    """Reference vocabulary: A3CConfiguration(seed, maxEpochStep, maxStep,
    numThread, nstep, gamma, ...)."""

    seed: int = 123
    max_epoch_step: int = 500
    max_step: int = 20000
    num_threads: int = 8          # reference numThread -> batched workers
    n_step: int = 16
    gamma: float = 0.99
    learning_rate: float = 1e-3
    entropy_coef: float = 0.01
    value_coef: float = 0.5
    hidden: tuple = (64, 64)


class A3CDiscreteDense:
    """Dense-observation discrete-action A3C (reference:
    A3CDiscreteDense). ``train()`` runs batched synchronous workers;
    ``get_policy()`` returns the greedy softmax policy. ``params`` is a flat
    ``{name: tensor}`` dict: the trunk's ``W{i}``/``b{i}`` and the policy
    (``Wp``, ``bp``) and value (``Wv``, ``bv``) heads."""

    def __init__(self, mdp_factory: Callable[[], MDP],
                 conf: Optional[A3CConfiguration] = None, device=None) -> None:
        self.conf = conf or A3CConfiguration()
        c = self.conf
        self.device = default_device(device)
        self.envs: List[MDP] = [mdp_factory() for _ in range(c.num_threads)]
        probe = self.envs[0]
        self.obs_size = probe.observation_size
        self.n_actions = probe.action_size

        # shared trunk with policy + value heads, as one flat param dict
        rng = np.random.RandomState(c.seed)
        gen = torch.Generator().manual_seed(c.seed)
        sizes = (self.obs_size,) + tuple(c.hidden)

        def normal(shape, scale):
            return torch.randn(shape, generator=gen, dtype=torch.float32) * scale

        params = {}
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            params[f"W{i}"] = normal((a, b), float(np.sqrt(2.0 / a)))
            params[f"b{i}"] = torch.zeros(b)
        h = sizes[-1]
        params["Wp"] = normal((h, self.n_actions), 0.01)
        params["bp"] = torch.zeros(self.n_actions)
        params["Wv"] = normal((h, 1), 0.01)
        params["bv"] = torch.zeros(1)
        self.params = {k: v.to(self.device).requires_grad_(True) for k, v in params.items()}
        self.opt = Adam(learning_rate=c.learning_rate).to_transform()
        self.opt_state = self.opt.init(self.params)
        self.episode_rewards: List[float] = []
        self._rng = rng

    def _put(self, arr) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if t.dtype == torch.int32:
            t = t.long()
        return t.to(self.device)

    # --- the device pieces ---------------------------------------------

    def _forward(self, params, obs):
        h = obs
        i = 0
        while f"W{i}" in params:
            h = torch.relu(h @ params[f"W{i}"] + params[f"b{i}"])
            i += 1
        logits = h @ params["Wp"] + params["bp"]
        value = (h @ params["Wv"] + params["bv"])[:, 0]
        return logits, value

    def _loss(self, params, obs, actions, returns):
        c = self.conf
        logits, value = self._forward(params, obs)
        logp = torch.log_softmax(logits, dim=-1)
        probs = torch.exp(logp)
        adv = returns - value
        # batch-normalized advantages (population std, as jnp.std): the
        # synchronous batch replaces the reference's per-thread updates,
        # whose implicit staggering kept early huge advantages from
        # saturating the policy
        adv_n = ((adv - torch.mean(adv))
                 / (torch.std(adv, correction=0) + 1e-8)).detach()
        chosen = torch.gather(logp, 1, actions[:, None])[:, 0]
        policy_loss = -torch.mean(chosen * adv_n)
        entropy = -torch.mean(torch.sum(probs * logp, dim=1))
        value_loss = torch.mean(adv ** 2)
        return (policy_loss + c.value_coef * value_loss
                - c.entropy_coef * entropy)

    def _update(self, obs, actions, returns) -> torch.Tensor:
        """One Adam step on the n-step loss, in place; returns the loss."""
        loss = self._loss(self.params, obs, actions, returns)
        names = list(self.params)
        grads = torch.autograd.grad(loss, [self.params[k] for k in names])
        with torch.no_grad():
            updates, self.opt_state = self.opt.update(dict(zip(names, grads)),
                                                      self.opt_state, self.params)
            apply_updates(self.params, updates)
        return loss.detach()

    # --- environment interaction --------------------------------------

    def _act(self, obs_batch: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            logits, _ = self._forward(self.params, self._put(obs_batch))
            probs = torch.softmax(logits, dim=-1).cpu().numpy()
        return np.asarray([
            self._rng.choice(self.n_actions, p=probs[i] / probs[i].sum())
            for i in range(len(probs))
        ])

    def train(self, on_episode_end: Optional[Callable[[int, float], None]]
              = None) -> "A3CDiscreteDense":
        c = self.conf
        obs = np.stack([e.reset() for e in self.envs]).astype(np.float32)
        ep_reward = np.zeros(len(self.envs))
        steps = 0
        episode = 0
        while steps < c.max_step:
            # n-step rollout across all workers, in lockstep
            roll_obs, roll_act, roll_rew, roll_done = [], [], [], []
            for _ in range(c.n_step):
                actions = self._act(obs)
                next_obs = np.empty_like(obs)
                rewards = np.zeros(len(self.envs), np.float32)
                dones = np.zeros(len(self.envs), np.float32)
                for i, env in enumerate(self.envs):
                    reply = env.step(int(actions[i]))
                    rewards[i] = reply.reward
                    ep_reward[i] += reply.reward
                    if reply.done:
                        dones[i] = 1.0
                        self.episode_rewards.append(float(ep_reward[i]))
                        if on_episode_end:
                            on_episode_end(episode, float(ep_reward[i]))
                        episode += 1
                        ep_reward[i] = 0.0
                        next_obs[i] = env.reset()
                    else:
                        next_obs[i] = reply.observation
                roll_obs.append(obs.copy())
                roll_act.append(actions)
                roll_rew.append(rewards)
                roll_done.append(dones)
                obs = next_obs.astype(np.float32)
                steps += len(self.envs)

            # n-step discounted returns bootstrapped from V(s_{t+n})
            with torch.no_grad():
                _, boot = self._forward(self.params, self._put(obs))
            ret = boot.cpu().numpy().astype(np.float32)
            returns = []
            for t in reversed(range(len(roll_rew))):
                ret = roll_rew[t] + c.gamma * ret * (1.0 - roll_done[t])
                returns.append(ret.copy())
            returns.reverse()

            flat_obs = np.concatenate(roll_obs)
            flat_act = np.concatenate(roll_act).astype(np.int32)
            flat_ret = np.concatenate(returns).astype(np.float32)
            self._update(self._put(flat_obs), self._put(flat_act),
                         self._put(flat_ret))
        return self

    # --- reference API surface ----------------------------------------

    def get_policy(self):
        """The greedy policy over the params as they stand now (a detached
        copy: later training does not move it)."""
        fwd, put = self._forward, self._put
        params = {k: p.detach().clone() for k, p in self.params.items()}

        class _Policy:
            def next_action(self, observation: np.ndarray) -> int:
                with torch.no_grad():
                    logits, _ = fwd(params, put(np.asarray(observation[None], np.float32)))
                return int(torch.argmax(logits[0]))

        return _Policy()
