from .base import Model, Inconsistent, inconsistent
from .versioned_register import VersionedRegister
from .mutex import Mutex
from .cas_register import CASRegister

__all__ = ["Model", "Inconsistent", "inconsistent", "VersionedRegister",
           "Mutex", "CASRegister"]
