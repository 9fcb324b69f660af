from nomad_tpu_torch.state.store import StateSnapshot, StateStore, StateRestore, WatchItem

__all__ = ["StateStore", "StateSnapshot", "StateRestore", "WatchItem"]
