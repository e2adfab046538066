"""proofbench: the benchmark of groth16_tpu_torch (see BENCHMARK.json)."""
