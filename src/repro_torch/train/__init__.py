"""Training substrate: optimizers, train-step factory, grad compression."""
from . import compress
from .optimizer import (AdafactorConfig, AdamWConfig, adafactor_init,
                        adafactor_update, adamw_init, adamw_update,
                        clip_by_global_norm, make_optimizer)
from .step import make_train_step, opt_state_pspecs

__all__ = ["AdamWConfig", "AdafactorConfig", "adamw_init", "adamw_update",
           "adafactor_init", "adafactor_update", "make_optimizer",
           "clip_by_global_norm", "make_train_step", "opt_state_pspecs",
           "compress"]
