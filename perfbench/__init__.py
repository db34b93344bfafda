"""The benchmark of viquae_torch: ``python3 perfbench/run.py --workload
<name> --seed <n> --seconds <s> --trace <0|1>`` (see ``run.py``)."""
