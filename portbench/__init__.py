"""The benchmark of ``amw_tpu_torch``, the PyTorch and CUDA port of the
mastering system: ``python3 -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.  See ``README.md``."""
