"""Reinforcement learning tier (port of ``deeplearning4j_tpu/rl``).

Reference: rl4j (SURVEY.md §2.2 "RL4J"): MDP environment interface,
experience replay, DQN/double-DQN with target network, epsilon-greedy
policies. The Q-update computes TD targets on the card; the environment
loop stays host-side (tiny, sequential by nature).
"""

from .mdp import MDP, CartPole, StepReply
from .replay import ExpReplay, Transition
from .policy import EpsGreedyPolicy, GreedyPolicy
from .a3c import A3CConfiguration, A3CDiscreteDense
from .dqn import QLearningConfiguration, QLearningDiscreteDense

__all__ = [
    "A3CConfiguration",
    "A3CDiscreteDense",
    "CartPole",
    "EpsGreedyPolicy",
    "ExpReplay",
    "GreedyPolicy",
    "MDP",
    "QLearningConfiguration",
    "QLearningDiscreteDense",
    "StepReply",
    "Transition",
]
