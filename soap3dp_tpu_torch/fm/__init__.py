"""FM-index primitives and the seed search, on torch tensors."""
