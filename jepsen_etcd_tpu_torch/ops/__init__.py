"""Host packing and device search for the linearizability checker."""
