"""The port's copies of the binarizers' helpers that inference uses (the
binarizers themselves belong to the data-pipeline slice)."""
