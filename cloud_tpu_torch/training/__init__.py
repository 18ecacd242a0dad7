"""Training of the port: the train state and step, and its optimizers."""
