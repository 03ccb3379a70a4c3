"""Dense models: layers, attention, the layer stack, the model facade and
the weight carry-over from the JAX reference."""
