"""The reference's verifier key of a circuit given as columns
(`reference/vk.columns_verifier_key`) against the spec's `preprocess`
(`zprize_tpu_torch/ref/prover.py`), commitment by commitment with the
four lookup-table columns and `q_lookup`, on the lookup circuit of
`tests/test_torch_circuit.py` and on a circuit with a gate of every
widget; and against the Merkle circuit's template path at heights 2
and 3. The key depends on the circuit's layout alone, not its witness.

Run: python3 -m pytest portbench/tests/test_portbench_vk.py -q"""

import pytest

from zprize_tpu_torch.circuit import Point, StandardComposer
from zprize_tpu_torch.curve import jubjub
from zprize_tpu_torch.circuit.gates_ext import fixed_group_add
from zprize_tpu_torch.protocol.transcript_protocol import TranscriptProtocol
from zprize_tpu_torch.ref import prover as rp
from zprize_tpu_torch.ref.kzg import SRS

from portbench.reference import vk as ref_vk
from portbench.reference.circuit import GADGET_GATES, MerkleCircuit
from portbench.reference.spec.circuit.composer import SELECTOR_NAMES

TAU = 0x1234567890ABCDEF1234567890ABCDEF


def _lookup(cs):
    """tests/test_torch_circuit.py `_lookup`."""
    cs.lookup_table.insert_multiple_xor(0, 4)
    a = cs.add_input(2)
    b = cs.add_input(3)
    c = cs.add_input(1)
    cs.lookup_gate(a, b, c)
    return cs


def _every_widget(cs):
    """A gate of each widget: arithmetic (with the Poseidon rounds'
    fifth-power and fourth-wire selectors), range, logic, fixed-base (one
    row of the scalar multiplication's), curve addition, lookup: every
    selector has a row that is not 0. The table's 9 rows start at
    (1, 1, 0, 0), so its padding shows."""
    cs.lookup_table.insert_multiple_xor(1, 4)
    a, b = cs.add_input(2), cs.add_input(3)
    cs.lookup_gate(a, b, cs.add_input(1))
    cs.range_gate(a, 4)
    cs.xor_gate(a, b, 4)
    gx, gy = jubjub.GENERATOR
    g = Point(cs.add_input(gx), cs.add_input(gy))
    cs.point_addition_gate(g, g)
    fixed_group_add(cs, cs.zero_var, cs.add_input(1), cs.zero_var,
                    cs.add_input(gx * gy), gx, gy, gx * gy)
    cs.mul(a, b)
    cs.full_affine_transform_gate([a, b, a], [5, 6, 7, 8, 9])
    cs.partial_affine_transform_gate([a, b, a], [5, 6, 7, 8, 9])
    return cs


@pytest.mark.parametrize("build", [_lookup, _every_widget])
def test_columns_key_equals_the_spec_preprocess(build):
    cs = build(StandardComposer())
    n = cs.circuit_bound()
    _, want = rp.preprocess(cs, SRS.setup(n, tau=TAU),
                            TranscriptProtocol(b"vk"))
    assert build is _lookup or (n > cs.lookup_table.size() and all(
        any(getattr(cs, name)) for name in SELECTOR_NAMES))
    got = ref_vk.columns_verifier_key(
        n, {name: getattr(cs, name) for name in SELECTOR_NAMES},
        ref_vk.sigma_of_cycles(cs.var_map.values(), n),
        cs.lookup_table.columns(), TAU, workers=2)
    assert got.n == want.n == n
    assert got.commitments == want.commitments
    assert "q_lookup" in got.commitments and got.commitments["q_lookup"]
    assert got.table_commitments == want.table_commitments
    assert all(c is not None for c in got.table_commitments[:3])


def _merkle_columns(circuit):
    """The Merkle circuit's selectors, row by row."""
    t, g0 = circuit.template, circuit.gadget_start
    cols = {}
    for name in SELECTOR_NAMES:
        col = [0] * circuit.n
        col[:g0] = t.prologue_selectors[name]
        col[g0:g0 + GADGET_GATES * circuit.n_gadgets] = \
            t.selectors[name] * circuit.n_gadgets
        col[circuit.root_gate_pos] = circuit.root_selectors().get(name, 0)
        cols[name] = col
    return cols


@pytest.mark.parametrize("height", [2, 3])
def test_columns_key_equals_the_merkle_template_path(height):
    circuit = MerkleCircuit(height)
    want = ref_vk.verifier_key(circuit, TAU, workers=2)
    got = ref_vk.columns_verifier_key(
        circuit.n, _merkle_columns(circuit), circuit.sigma_flat(),
        [[], [], [], []], TAU, workers=2)
    assert got.n == want.n == circuit.n
    assert got.commitments == want.commitments
    assert got.table_commitments == want.table_commitments == [None] * 4


def test_a_column_of_the_wrong_length_is_refused():
    with pytest.raises(ValueError, match="n = 16 rows"):
        ref_vk.columns_verifier_key(
            16, {name: [0] * 15 for name in SELECTOR_NAMES},
            list(range(64)), [[], [], [], []], TAU, workers=1)
