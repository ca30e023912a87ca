"""Model families of the port (llama only in this slice)."""
