"""Model definitions of the port: the dense, moe, ssm, hybrid, vlm and
enc-dec (audio) families.

Plain functions on torch tensors with the JAX package's layouts and
parameter keys; :func:`build_model` is the uniform facade.
"""

from repro_torch.models.model_zoo import Model, build_model  # noqa: F401
