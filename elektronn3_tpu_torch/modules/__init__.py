"""NN building blocks (activations, normalization, batch-norm
prologues) for the port's models."""
