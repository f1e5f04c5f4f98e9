"""The benchmark of tpu_ofdm_torch: see BENCHMARK.json and PERF.md."""
