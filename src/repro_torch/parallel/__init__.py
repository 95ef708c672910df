from .mesh import MeshSpec, data_axes, model_axis
from .sharding import (param_pspecs, batch_pspecs, cache_pspecs,
                       opt_state_pspecs)

__all__ = ["MeshSpec", "data_axes", "model_axis", "param_pspecs",
           "batch_pspecs", "cache_pspecs", "opt_state_pspecs"]
