"""Runtime audits of the port (``NEXUS_SANITIZE``)."""
