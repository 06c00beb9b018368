"""Evaluation tools of the port, run with ``python -m``:
:mod:`.eval_testdata_kf` (one checkpoint's KF against true trees) and
:mod:`.eval_curve` (the KF of every step of a training run)."""
