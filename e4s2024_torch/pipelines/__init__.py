"""The face-swap pipeline: mask merge and the aligned-crop swap."""
