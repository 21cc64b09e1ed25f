"""Model code of the port: configs, layers, the serving subset of the
transformer, and the carry-over of JAX parameters."""
