"""The face-swap pipelines: mask merge, the aligned-crop and raw-frame swaps, detection, alignment and landmark smoothing."""
