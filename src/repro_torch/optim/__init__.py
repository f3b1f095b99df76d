"""repro_torch.optim — the optimizers, schedules and gradient compression
of ``repro.optim``, functional as there: ``update`` returns new trees and
writes nothing in place (a staged parameter may be a view of a retained
transfer bucket)."""
from .optimizers import Optimizer, adamw, adafactor, sgdm, make_optimizer
from .schedules import constant, warmup_cosine
from . import compression

__all__ = ["Optimizer", "adamw", "adafactor", "sgdm", "make_optimizer",
           "constant", "warmup_cosine", "compression"]
