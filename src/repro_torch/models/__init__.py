"""Models of the port: the language models, the vision transformers,
ResNet-50 and the diffusion family.  Parameters are nested dicts of
tensors in the JAX package's layouts, so one set of numpy weights drives
both packages."""
