"""The benchmark of text2speech_tpu_torch: one cell of BENCHMARK.json per
run of ``python3 perfbench/run.py``."""
