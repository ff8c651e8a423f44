from repro_torch.runtime.server import Server  # noqa: F401
from repro_torch.runtime.straggler import StragglerDetector  # noqa: F401
from repro_torch.runtime.trainer import Trainer  # noqa: F401
