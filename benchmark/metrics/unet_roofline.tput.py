"""unet_roofline.tput: the least time of a UNet forward at the cell's shapes
over the device time inside the traced ``"unet"`` ranges, %."""

from a2bench import window


def read(w):
    return window.unet_roofline(w)
