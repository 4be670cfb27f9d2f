"""Diagnostics & observability: probes, plots, energy, convergence tracing.

Port of multimodal_idbn_tpu/utils/__init__.py:1-22, with the same
re-exports. No module here imports matplotlib, pandas or wandb when it is
imported: the numbers are computed without them, and a figure is drawn
only where matplotlib is installed (``wandb_compat.pyplot``).
"""

from multimodal_idbn_tpu_torch.utils.pca import (  # noqa: F401
    PCA, pca_fit_transform)
from multimodal_idbn_tpu_torch.utils.probe_utils import (  # noqa: F401
    compute_joint_embeddings_and_features,
    compute_val_embeddings_and_features,
    log_joint_linear_probe,
    log_linear_probe,
    make_bin_labels,
    stratified_split,
    train_linear_classifier,
)
from multimodal_idbn_tpu_torch.utils.wandb_utils import (  # noqa: F401
    log_barplot,
    log_reconstructions_to_wandb,
    make_grid,
    plot_2d_embedding_and_correlations,
    plot_3d_embedding_and_correlations,
)
