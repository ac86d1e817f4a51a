"""Training of FCN-LectureNet: the three-phase curriculum (reconstruction
pretraining, text-detector pretraining, the binarizer) on the card."""
