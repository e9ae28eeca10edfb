"""The port's models: the configuration dataclasses and the dense
decoder-only subset that the lazy LM lane admits."""
