"""Model families: the FM synthesizer topologies."""
from .fm import FM2, FM3_PARALLEL, FM3_SERIES, TOPOLOGIES, FMTopology, get_topology

__all__ = ["FM2", "FM3_PARALLEL", "FM3_SERIES", "TOPOLOGIES", "FMTopology", "get_topology"]
