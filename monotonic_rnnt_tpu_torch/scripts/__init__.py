"""The card's acceptance and fuzz harness (the counterparts of the
repository's ``scripts/tpu_acceptance.py``, ``fuzz_tpu.py`` and
``run_acceptance.py``): ``python -m monotonic_rnnt_tpu_torch.scripts.<name>``.
``_cases`` holds the case builders and checks they share with
``chip_smoke.py``."""
