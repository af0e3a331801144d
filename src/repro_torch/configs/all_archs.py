"""Import side-effects: registering every assigned architecture."""
from . import (arctic_480b, grok1_314b, jamba_1_5_large, mamba2_130m,  # noqa
               musicgen_medium, olmo_1b, paligemma_3b, phi4_mini_3_8b,
               qwen2_5_32b, yi_34b)
