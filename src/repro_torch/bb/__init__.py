"""The port's burst-buffer service (the functional plane)."""
from .service import (BBClient, BBCluster, BBFile, BBServer, JobMeta,
                      Request, phase_at)

__all__ = ["BBClient", "BBCluster", "BBFile", "BBServer", "JobMeta",
           "Request", "phase_at"]
