"""The plain reference that decides ``correct``: its own genome index,
ungapped search and affine-gap DP in NumPy, and the judge of the SAM
records. It imports neither JAX nor the port."""
