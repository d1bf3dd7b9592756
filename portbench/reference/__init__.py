"""Plain references: field, SHA-256, transcript, PCS and SNARK provers in
ordinary PyTorch integer ops.  Nothing here imports the program under test."""
