"""The NOMAD core: the Cauchy kernel, the losses, the estimator and its
steps, the PCA start, the execution strategies and the fit's event API.

Every name of the JAX package's ``repro.core`` is exported. The Cauchy
kernel (which imports only torch) is bound here, since its submodule shares
the name ``cauchy``; the rest load on first use (PEP 562), so
``repro_torch.core.runtime`` stays importable below the fit, the build and
serving, which import it (an eager ``nomad`` import here would close an
import cycle through ``repro_torch.index.build``).
"""

from __future__ import annotations

import importlib

from repro_torch.core.cauchy import cauchy, cauchy_pairwise

_WHERE = {
    "contrastive_loss": "losses",
    "infonc_tsne_loss": "losses",
    "nomad_loss": "losses",
    "NomadProjection": "nomad",
    "FitResult": "nomad",
    "make_step_fn": "nomad",
    "make_epoch_fn": "nomad",
    "pca_init": "pca",
    "ExecutionStrategy": "strategy",
    "LocalStrategy": "strategy",
    "ShardedStrategy": "strategy",
    "HierarchicalStrategy": "strategy",
    "resolve_strategy": "strategy",
    "FitCallbacks": "strategy",
    "CallbackList": "strategy",
    "EpochStartEvent": "strategy",
    "EpochEndEvent": "strategy",
    "MeansRefreshEvent": "strategy",
    "CheckpointEvent": "strategy",
}

__all__ = ["cauchy", "cauchy_pairwise", *_WHERE]


def __getattr__(name: str):
    if name not in _WHERE:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_WHERE[name]}"), name)
    globals()[name] = value
    return value
