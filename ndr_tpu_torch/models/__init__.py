"""Neural design-representation models (counterpart of
``ndr_tpu.models``): the Fourier-feature MLP with its multi-head
continual-learning variant, SIREN, and the CNN and deconv generators."""

from ndr_tpu_torch.models.mlp import (  # noqa: F401
    FourierFeatureMLP,
    MLPConfig,
    MultiHeadMLP,
    change_scale_value,
    fourier_encode,
    homogeneous_init,
    init_mlp,
    init_multihead_mlp,
    mlp_apply,
    mlp_apply_chunked,
    multihead_apply,
    params_from_jax,
    tree_state_dict,
)
from ndr_tpu_torch.models.siren import Siren, SirenConfig, init_siren, siren_apply  # noqa: F401
from ndr_tpu_torch.models.cnn import (  # noqa: F401
    CNNConfig,
    CNNGenerator,
    DeconvConfig,
    DeconvGenerator,
    cnn_apply,
    deconv_generator_apply,
    init_cnn,
    init_deconv_generator,
)
