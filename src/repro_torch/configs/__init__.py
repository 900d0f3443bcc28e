"""repro_torch.configs - the ten model configurations and the shape
registry (port of ``repro.configs``)."""
from repro_torch.configs.registry import (ARCHS, SHAPES, all_cells,
                                          cell_supported, get_config,
                                          input_specs)
