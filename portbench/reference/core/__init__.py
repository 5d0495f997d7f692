"""State model: constants, actions, dense state tensors, static config."""
