"""A frozen NumPy copy of the port's own AV1 decoder and the host modules
it needs, cut to the tools the cells' streams use. It shares its context,
MV-prediction and availability code with the encoder it judges, so it
checks that a stream is self-consistent, not that it is conforming AV1."""
