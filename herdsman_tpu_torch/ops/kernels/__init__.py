"""Hand-written CUDA kernels (``csrc/``), their wrappers and plain versions."""


def wrappers() -> dict:
    """Every kernel's wrapper by name; each counts its launches on the card
    in its ``launches``."""
    from herdsman_tpu_torch.ops.kernels import (bt, mega12, mega13, megaJ,
                                                megaT)
    from herdsman_tpu_torch.ops.kernels import rotate_decompose as rd
    return {"mega13": mega13.mega13_blind_rotate,
            "mega12": mega12.mega12_blind_rotate,
            "bt_external_product": bt.external_product_bt,
            "rotate_decompose": rd.rotate_decompose,
            "mega16": megaT.mega16_blind_rotate,
            "mega17": megaT.mega17_blind_rotate,
            "mega15": megaT.mega15_blind_rotate,
            "mega14": megaT.mega14_blind_rotate,
            "mega11": megaJ.mega11_blind_rotate,
            "mega8": megaJ.mega8_blind_rotate,
            "mega7": megaJ.mega7_blind_rotate,
            "mega9": megaJ.mega9_blind_rotate,
            "mega6": megaJ.mega6_blind_rotate,
            "mega10": megaJ.mega10_blind_rotate,
            "mega3": megaJ.mega3_blind_rotate,
            "mega4": megaJ.mega4_blind_rotate,
            "mega5": megaJ.mega5_blind_rotate,
            "mega": megaJ.mega_blind_rotate,
            "mega2": megaJ.mega2_blind_rotate}


def launch_counts() -> dict[str, int]:
    """Each kernel's launches in this process, by the names of
    ``wrappers``."""
    return {name: fn.launches for name, fn in wrappers().items()}
