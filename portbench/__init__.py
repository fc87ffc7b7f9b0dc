"""The benchmark of the PyTorch and CUDA port (`zprize_tpu_torch`): one
run of one cell of `BENCHMARK.json` (`run.py`, `harness.py`), the measured
window (`window.py`) and the traced one (`trace.py`), the inputs made from
the seed (`inputs.py`), the roofline yardstick (`roofline.py`), a file a
configuration (`configs/`), a traffic mix (`traffic/`) and a metric
(`metrics/`), and for each kind of configuration, its system, named by the
configuration's "system" key: its set-up (`systems/`), its seeded inputs
(`recipes/`) and the plain reference that judges its proofs
(`reference/`). Importing it loads neither torch nor the port."""
