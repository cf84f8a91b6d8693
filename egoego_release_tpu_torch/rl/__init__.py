from egoego_release_tpu_torch.rl.env import KinematicHumanoidEnv
from egoego_release_tpu_torch.rl.ppo import PPOAgent, PPOConfig
from egoego_release_tpu_torch.rl.rewards import REWARD_FUNCS, RewardContext
