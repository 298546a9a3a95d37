from . import classify, integrate, integrate_cuda, metrics, render
