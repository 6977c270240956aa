"""NN building blocks (activations, normalization, batch-norm
prologues, losses) for the port's models."""
