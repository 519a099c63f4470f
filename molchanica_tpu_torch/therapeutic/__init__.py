"""Therapeutic-property ML: target registry, training orchestration,
embedded-weights inference, ProteinMPNN.

Port of molchanica_tpu.therapeutic (reference parity: the `therapeutic`
crate trains 24 TDC ADMET targets and ships embedded models,
src/therapeutic/train.rs:1914, infer.rs:53, mod.rs:56-80).
"""
from .targets import TARGETS, TargetSpec          # noqa: F401
from .train import train_target, train_all        # noqa: F401
from .infer import TherapeuticPredictor           # noqa: F401
