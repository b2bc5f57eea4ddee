"""Training core of the port: optimizers and schedules, the train state,
the trainers, hooks, checkpoints and the experiment manager."""
