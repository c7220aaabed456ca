"""Activation placement hooks of the port's models (``activations``)."""
