"""Model families of the port (dense only in this slice)."""
