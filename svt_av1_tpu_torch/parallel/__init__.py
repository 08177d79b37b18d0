"""Multi-device paths of the port (``tiles``): tile-sharded key frames,
strip-sharded inter shape groups and the distributed deblocking filter,
over an explicit list of torch devices."""
