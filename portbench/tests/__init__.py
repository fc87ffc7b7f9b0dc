"""CPU tests of the benchmark (portbench/): run them with
python3 -m pytest portbench/tests -q"""
