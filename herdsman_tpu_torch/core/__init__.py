from herdsman_tpu_torch.core.params import (  # noqa: F401
    PARAM_SETS,
    STD128,
    STD128_K2,
    STD128_SHORTINT,
    TEST_PBS,
    TEST_SMALL,
    TFHEParams,
    TOY,
)
