from .merlin import Transcript
from .serialize import (
    serialize_fr,
    serialize_g1,
    fr_from_random_bytes,
    serialize_public_inputs,
)
