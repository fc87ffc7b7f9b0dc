from .composer import StandardComposer, LookupTable
from . import gates_ext  # noqa: F401  (attaches the extended gate library)
from .gates_ext import Point
