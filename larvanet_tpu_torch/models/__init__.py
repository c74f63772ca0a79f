"""Model zoo of the port; importing it registers every ported model."""

from larvanet_tpu_torch.models import ebrn  # noqa: F401
from larvanet_tpu_torch.models import edsr  # noqa: F401
from larvanet_tpu_torch.models import hrsr  # noqa: F401
from larvanet_tpu_torch.models import imdn  # noqa: F401
from larvanet_tpu_torch.models import larvanet  # noqa: F401
from larvanet_tpu_torch.models import mamnet  # noqa: F401
from larvanet_tpu_torch.models import msrr  # noqa: F401
from larvanet_tpu_torch.models import rego  # noqa: F401
from larvanet_tpu_torch.models import treenet  # noqa: F401
