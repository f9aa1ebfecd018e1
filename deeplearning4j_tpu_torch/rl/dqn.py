"""DQN / double-DQN over dense observations (port of
``deeplearning4j_tpu/rl/dqn.py``).

Reference: org.deeplearning4j.rl4j.learning.sync.qlearning.discrete.
QLearningDiscreteDense + QLearningConfiguration: epsilon-greedy rollout,
experience replay, TD targets from a periodically-synced target network,
double-DQN action selection.

The Q-network is a MultiLayerNetwork (config DSL) on the card; the TD
targets are computed there under ``no_grad`` (network forward x2, x3 for
double DQN) and fed to the network's own ``fit`` MSE step, mirroring how
the reference drives a DL4J model from its learning loop. The target
network is a detached clone of every parameter: the live parameters are
updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from ..nn import NeuralNetConfiguration
from ..nn.layers import DenseLayer, OutputLayer
from ..nn.losses import LossFunction
from ..nn.sequential import MultiLayerNetwork
from ..train.updaters import Adam
from .mdp import MDP
from .policy import EpsGreedyPolicy
from .replay import ExpReplay, Transition


def _detached_clone(params):
    """A copy of ``{layer: {name: tensor}}`` that no later in-place update
    of the live parameters reaches."""
    return {l: {k: p.detach().clone() for k, p in lp.items()} for l, lp in params.items()}


@dataclasses.dataclass
class QLearningConfiguration:
    """Reference: QLearningConfiguration (builder fields kept)."""

    seed: int = 123
    max_step: int = 10000
    max_epoch_step: int = 500
    exp_replay_size: int = 10000
    batch_size: int = 32
    target_dqn_update_freq: int = 100
    update_start: int = 100
    gamma: float = 0.99
    eps_start: float = 1.0
    min_epsilon: float = 0.05
    epsilon_nb_step: int = 3000
    double_dqn: bool = True
    learning_rate: float = 1e-3
    hidden: tuple = (64, 64)


class QLearningDiscreteDense:
    def __init__(self, mdp: MDP, conf: Optional[QLearningConfiguration] = None,
                 network: Optional[MultiLayerNetwork] = None, device=None) -> None:
        self.mdp = mdp
        self.conf = conf or QLearningConfiguration()
        c = self.conf
        self.network = network or self._default_network(device)
        self.target_params = _detached_clone(self.network.params)
        self.replay = ExpReplay(c.exp_replay_size, c.batch_size, seed=c.seed)
        self.policy = EpsGreedyPolicy(
            self._q_values, mdp.action_size, eps_start=c.eps_start,
            eps_min=c.min_epsilon, decay_steps=c.epsilon_nb_step, seed=c.seed)
        self.episode_rewards: List[float] = []
        self._steps = 0

    def _default_network(self, device) -> MultiLayerNetwork:
        c = self.conf
        b = (NeuralNetConfiguration.builder().seed(c.seed)
             .updater(Adam(learning_rate=c.learning_rate)).list())
        from ..nn.activations import Activation

        n_in = self.mdp.observation_size
        for h in c.hidden:
            b.layer(DenseLayer(n_in=n_in, n_out=h,
                               activation=Activation.RELU))
            n_in = h
        # IDENTITY head: Q-values are unbounded regression targets (the
        # OutputLayer default is the classifier's SOFTMAX)
        b.layer(OutputLayer(n_in=n_in, n_out=self.mdp.action_size,
                            loss=LossFunction.MSE,
                            activation=Activation.IDENTITY))
        return MultiLayerNetwork(b.build(), device=device).init()

    # --- device-side pieces -------------------------------------------

    def _forward(self, params, x: torch.Tensor) -> torch.Tensor:
        out, _, _ = self.network.forward_pure(params, self.network.state, x,
                                              train=False, rng=None)
        return out

    def _input(self, arr) -> torch.Tensor:
        return self.network._input(np.asarray(arr, np.float32))

    def _q_values(self, obs: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return self._forward(self.network.params, self._input(obs)).cpu().numpy()

    def _td_targets(self, obs, actions, rewards, next_obs, dones
                    ) -> np.ndarray:
        """Q-matrix with the taken actions' entries replaced by TD targets —
        feeding the standard fit(x, y) MSE step (the reference does the
        same through its DQN output layer)."""
        c = self.conf
        net = self.network
        dev = net.device
        with torch.no_grad():
            obs_t, next_t = self._input(obs), self._input(next_obs)
            q_now = self._forward(net.params, obs_t)
            q_next_t = self._forward(self.target_params, next_t)
            if c.double_dqn:
                next_a = torch.argmax(self._forward(net.params, next_t), dim=1)
            else:
                next_a = torch.argmax(q_next_t, dim=1)
            next_q = torch.gather(q_next_t, 1, next_a[:, None])[:, 0]
            rewards_t = torch.as_tensor(rewards, device=dev).to(q_now.dtype)
            dones_t = torch.as_tensor(dones, device=dev).to(q_now.dtype)
            targets = rewards_t + c.gamma * next_q * (1.0 - dones_t)
            rows = torch.arange(q_now.shape[0], device=dev)
            acts = torch.as_tensor(actions, device=dev).long()
            q_now[rows, acts] = targets
            return q_now.cpu().numpy()

    # --- learning loop ------------------------------------------------

    def train_step(self) -> None:
        obs, actions, rewards, next_obs, dones = self.replay.sample()
        y = self._td_targets(obs, actions, rewards, next_obs, dones)
        self.network.fit(obs, y)

    def train(self, on_episode_end: Optional[Callable[[int, float], None]]
              = None) -> List[float]:
        """Run the full learning loop (reference: QLearning.train())."""
        c = self.conf
        while self._steps < c.max_step:
            obs = self.mdp.reset()
            ep_reward = 0.0
            for _ in range(c.max_epoch_step):
                action = self.policy.next_action(obs)
                reply = self.mdp.step(action)
                self.replay.store(Transition(
                    obs, action, reply.reward, reply.observation,
                    reply.done))
                obs = reply.observation
                ep_reward += reply.reward
                self._steps += 1
                if self._steps >= c.update_start and len(self.replay) >= \
                        self.replay.batch_size:
                    self.train_step()
                if self._steps % c.target_dqn_update_freq == 0:
                    self.target_params = _detached_clone(self.network.params)
                if reply.done or self._steps >= c.max_step:
                    break
            self.episode_rewards.append(ep_reward)
            if on_episode_end:
                on_episode_end(len(self.episode_rewards), ep_reward)
        return self.episode_rewards

    def get_policy(self):
        """Greedy policy over the trained network (reference:
        getPolicy())."""
        from .policy import GreedyPolicy

        return GreedyPolicy(self._q_values)
