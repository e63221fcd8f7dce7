"""Hardware cost models of the port: ReRAM (the paper's currency), the
card's roofline constants, and the measured-timing autotune cache."""
from .autotune import (AutotuneCache, TuneKey, device_kind, get_cache,
                       load_cache, set_cache)
from .gpu_model import H100, GPUSpec
from .reram_model import (LayerMapping, ReRAMConfig, area_mm2, cycles,
                          energy_nj, summarize)
