"""RL fine-tuning of the port (counterpart of the JAX package's ``rl``):
replay buffers, the DQN policy, its rollout, the AIRL discriminator, PPO."""
