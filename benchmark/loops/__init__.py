"""Traffic loops, one module per kind of loop; a traffic file names its loop."""
