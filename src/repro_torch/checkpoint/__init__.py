"""Checkpointing (port of ``repro.checkpoint``): npz trees and the
sync-mode ``FederatedRun`` state that replays bit-identically."""
from repro_torch.checkpoint.checkpoint import restore, save  # noqa: F401
from repro_torch.checkpoint.run_state import load_run, save_run  # noqa: F401
