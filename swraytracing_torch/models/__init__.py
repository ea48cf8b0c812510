from . import (analytic, cgrid, coupled, coupled2, dispersion, examples,
               examples_1d, exact_linear, fields, frozen, qg, qg2, rays,
               reversible, rsw, sw1d)
from .dispersion import Dispersion

__all__ = ["analytic", "cgrid", "coupled", "coupled2", "dispersion",
           "examples", "examples_1d", "exact_linear", "fields", "frozen",
           "qg", "qg2", "rays", "reversible", "rsw", "sw1d", "Dispersion"]
