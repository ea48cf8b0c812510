from . import (coupled, coupled2, dispersion, fields, frozen, qg, qg2,
               rays)
from .dispersion import Dispersion

__all__ = ["coupled", "coupled2", "dispersion", "fields", "frozen", "qg",
           "qg2", "rays", "Dispersion"]
