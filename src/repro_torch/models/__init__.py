"""Model building blocks of the port (norms, activations, init)."""
