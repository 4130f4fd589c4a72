from repro_torch.roofline.analysis import (  # noqa: F401
    H100, HW, bound, roofline_report)
from repro_torch.roofline.retrieve import (  # noqa: F401
    RetrieveShape, hbm_bytes, roofline)
