"""The parts of the executable-spec prover (`zprize_tpu/ref/prover.py`)
that the device prover and verifier need: commitment order, the verifier
key and transcript seeding. Copied verbatim."""

from ..protocol.transcript_protocol import TranscriptProtocol

SELECTOR_ORDER = [  # commit order in preprocess_shared (preprocess.rs:418-440)
    "q_m", "q_l", "q_r", "q_o", "q_4", "q_c", "q_hl", "q_hr", "q_h4",
    "q_arith", "q_range", "q_logic", "q_lookup", "q_fixed_group_add",
    "q_variable_group_add",
]

SEED_ORDER = [  # transcript seeding order (widget/mod.rs seed_transcript)
    ("q_m", b"q_m"), ("q_l", b"q_l"), ("q_r", b"q_r"), ("q_o", b"q_o"),
    ("q_c", b"q_c"), ("q_4", b"q_4"), ("q_hl", b"q_hl"), ("q_hr", b"q_hr"),
    ("q_h4", b"q_h4"), ("q_arith", b"q_arith"), ("q_range", b"q_range"),
    ("q_logic", b"q_logic"),
    ("q_variable_group_add", b"q_variable_group_add"),
    ("q_fixed_group_add", b"q_fixed_group_add"),
    ("left_sigma", b"left_sigma"), ("right_sigma", b"right_sigma"),
    ("out_sigma", b"out_sigma"), ("fourth_sigma", b"fourth_sigma"),
]

SIGMA_NAMES = ["left_sigma", "right_sigma", "out_sigma", "fourth_sigma"]


class VerifierKey:
    def __init__(self, n, commitments, table_commitments):
        self.n = n
        self.commitments = commitments          # name -> G1 point
        self.table_commitments = table_commitments  # 4 points


def seed_transcript(transcript: TranscriptProtocol, vk: VerifierKey):
    for name, label in SEED_ORDER:
        transcript.append_g1(label, vk.commitments[name])
    transcript.circuit_domain_sep(vk.n)
