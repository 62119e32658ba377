"""Fitting energy, LM solver, initializer and staged fit of the port."""
