"""The runtime-spec fields that the port's train path reads."""
