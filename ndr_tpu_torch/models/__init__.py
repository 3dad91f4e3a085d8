"""Neural design-representation models (the port has the Fourier-feature
MLP of ``ndr_tpu.models.mlp``)."""

from ndr_tpu_torch.models.mlp import (  # noqa: F401
    FourierFeatureMLP,
    MLPConfig,
    fourier_encode,
    homogeneous_init,
    init_mlp,
    mlp_apply,
    mlp_apply_chunked,
    params_from_jax,
)
