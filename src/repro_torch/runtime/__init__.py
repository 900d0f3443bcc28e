from repro_torch.runtime.fault_tolerance import (Heartbeat, SimulatedFailure,
                                                 StragglerDetector,
                                                 run_with_restarts)
