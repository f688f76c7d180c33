"""Training substrate of the port: the train step, the fault-tolerant
loop, straggler detection and fault injection (elastic re-meshing comes
with the port's sharding)."""
from .step import TrainState, init_train_state, make_train_step

__all__ = ["TrainState", "make_train_step", "init_train_state"]
