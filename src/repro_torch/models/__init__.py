"""Models of the port (the vision transformers so far).  Parameters are
nested dicts of tensors in the JAX package's layouts, so one set of
numpy weights drives both packages."""
