from . import (analytic, coupled, coupled2, dispersion, fields, frozen, qg,
               qg2, rays, reversible)
from .dispersion import Dispersion

__all__ = ["analytic", "coupled", "coupled2", "dispersion", "fields",
           "frozen", "qg", "qg2", "rays", "reversible", "Dispersion"]
