"""RL substrate of the port: rollout engine, weight store, rollout record."""
