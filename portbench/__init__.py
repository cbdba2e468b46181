"""The benchmark of ``juliaraytracingsw_tpu_torch``; see ``README.md``.
``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""
