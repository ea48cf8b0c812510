from . import coupled, coupled2, dispersion, fields, qg, qg2
from .dispersion import Dispersion

__all__ = ["coupled", "coupled2", "dispersion", "fields", "qg", "qg2",
           "Dispersion"]
