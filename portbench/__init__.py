"""The benchmark of the PyTorch and CUDA port (`zprize_tpu_torch`): one
run of one cell of `BENCHMARK.json` (`run.py`, `harness.py`), the inputs
made from the seed (`inputs.py`), the traced window (`trace.py`), the
roofline yardstick (`roofline.py`), a system module a kind of configuration
(`systems/`), a file a configuration (`configs/`), a traffic mix
(`traffic/`) and a metric (`metrics/`), and the plain reference that
judges the proofs (`reference/`). Importing it loads neither torch nor
the port."""
