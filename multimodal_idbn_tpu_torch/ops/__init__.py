"""Pure tensor operations of the port (multimodal_idbn_tpu/ops), with the
names the JAX package's ``ops`` re-exports (ops/__init__.py:3-23)."""

from multimodal_idbn_tpu_torch.ops.rbm_ops import (  # noqa: F401
    RBMState,
    cd_update,
    clamped_cd_update,
    conditional_gibbs,
    conditional_gibbs_annealed,
    free_energy,
    gibbs_step,
    hidden_probs,
    init_rbm_state,
    noisy_meanfield_annealed,
    visible_logits,
    visible_probs,
)
from multimodal_idbn_tpu_torch.ops.sampling import (  # noqa: F401
    apply_softmax_groups,
    clamp_mask,
    sample_bernoulli,
    sample_categorical_onehot,
    sample_visible,
)
