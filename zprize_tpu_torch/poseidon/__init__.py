from .constants import PoseidonConstants
