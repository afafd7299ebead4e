"""FourierFT math (`fourierft`), the adapter-method protocol (`adapter`) and
the PEFT attachment layer (`peft`)."""
