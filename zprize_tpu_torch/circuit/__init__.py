from .composer import StandardComposer, LookupTable
