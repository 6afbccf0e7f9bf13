from .constants import Constants, DEFAULT_CONSTANTS
from .coupler import Coupler, Tracer, hmean
